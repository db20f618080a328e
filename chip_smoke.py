#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quant_tpu_torch) on one NVIDIA card.

Run from the root of the repository, with one CUDA device:

    python3 chip_smoke.py

Phases; the first failure ends the run with a non-zero exit code:

1. device    name, count, and ``nvidia-smi`` name / power limit.
2. build     nvcc of the five CUDA sources (one process each, in parallel),
             with the register / shared-memory report of ``-Xptxas -v``.
3. kernels   each kernel against its plain PyTorch version at the
             Llama-3-8B shapes and the output dtypes the forward gives
             them, with its device time (``torch.profiler`` kernel events,
             operands rotated so each launch reads them from device
             memory), its bound and the plain version's device time. The
             GQA inserts are fused with RoPE and K/V quantization: q, k
             and v bf16 views of one wqkv row at B=8, Hq 32, Hkv 8, Dh 128,
             into the 32-layer contiguous cache (S=2048) and page pools
             (pages 128 and 16), codes and scales byte-equal to the plain
             chain and q bit-equal, beside the plain chain's device time;
             how PyTorch's ``absmax / 127.0`` rounds on the card is
             counted first. Paged flash decode runs over a 32-layer pool
             holding the contiguous cache's rows under a shuffled page
             table, at pages 128 and 512, beside the contiguous kernel's
             time at the same lengths. Each decode-attention row (B=8,
             Hkv=8, rep=4 over 8014 tokens; Hkv=4, rep=8, Qwen3-30B-A3B's
             heads; 8 slots of 8192 tokens over a 2-layer stack,
             contiguous and paged at page 128) runs f32 q and bf16 q, is
             counted under the path it should take (tc for bf16 q), must
             give bit-equal outputs on a second call, and gives
             ``sdpa_bf16_ms`` beside it: torch's
             scaled_dot_product_attention over the same context
             dequantized to bf16 ahead of time, with the backend that ran
             (a yardstick; the port never calls it). Each matmul row names the tile that
             served it (tc_decode, tc_prefill or cuda_core); a
             ``dequant_matmul`` row also gives ``dense_bf16_ms``,
             torch.matmul of the same x with the weights dequantized to
             bf16 ahead of time (the prefill target; the port never calls
             it). ``dequant_matmul_moe`` at the
             Mixtral-8x7B, Qwen3-30B-A3B, DeepSeek-V2-Lite (groups of 64,
             down K padded) and DeepSeek-V3 expert shapes: all experts at
             decode and prefill M, and hot lists of n_hot experts, each
             output handed out NaN-filled. The MLA pair over a 27-layer
             DeepSeek latent cache (B=8, Dq=640, r=512, the attention rows'
             lengths): the fused latent insert (RMSNorm, interleaved yarn
             RoPE of k_pe and q_pe, quantization, insert and q_eff in one
             launch) at DeepSeek-V2-Lite's (H=16) and V3's (H=128, low-rank
             q) widths, ckv and q_pe bf16 views of the projection rows,
             q_eff bit-equal to the plain chain and the latent byte-equal
             or within one code (differing codes counted, at most 1e-3),
             beside the plain chain's device time; the decode kernel at
             16 and 128 heads and over 8 slots of 8192 tokens
             (4 layers) at 16, each decode row like the GQA rows (path
             counted, rerun bit-equal, ``sdpa_bf16_ms`` over the latent
             dequantized to bf16 as MQA with Dk=640, Dv=512), and
             ``dequant_matmul`` at the
             DeepSeek-V2-Lite shapes (int4, groups of 64) and the
             DeepSeek-V3 shapes (groups of 128). ``unpack_int4_device``
             bit-exact against its plain version and the host codec (the
             C++ oracle's unpack) at 512x512 random codes and Llama-3-8B's
             ``w_gate_up`` and ``lm_head`` shapes. Both GQA decode kernels
             with a sliding window and a logit softcap, contiguous and
             paged (page 128), f32 and bf16 q, like the other decode rows,
             at Gemma-2-9B's decode shape (B=8, Hkv=8, rep=2, Dh=256, 42
             layers of S=8192, lengths from 1 to 8192; a local layer,
             window 4096 and softcap 50 at scale 1/16, and a global one,
             softcap 50) and Mistral-7B's (Dh=128, rep=4, window 4096),
             each bound counting the min(window, length) keys a slot reads.
             The int4 head-pair cache (``kv_bits=4``): both fused inserts
             at the Llama-3-8B B=8 shapes (codes and scales byte-equal to
             the plain chain; how ``absmax / 7.0`` rounds on the card is
             counted beside the 127.0 one), both decode kernels over the
             8014-token lengths (32 layers) and 8 slots of 8192 tokens,
             contiguous and paged at page 128, and Gemma-2-9B's local
             layer (window 4096, softcap 50), each like the int8 rows and
             counted under [kv4], its bound counting Dh bytes of K and V
             codes a token and real head.
4. serving   full-width Llama-3-8B (32 layers, random weights from seed 0,
             made on the card) behind ``Engine(max_slots=8, max_seq=2048)``:
             8 greedy requests of 32-1024 prompt tokens, 64 new tokens each.
             The launch counters must match the forwards run (every GQA
             serving phase: one fused insert per layer and decode forward,
             all under [fused]), and every matmul of a serving phase must
             take a tensor-core tile and every decode-attention call the
             tensor-core path. Then ``torch.profiler`` over 3 decode
             forwards at B=8: device busy time, idle share, device kernels
             and kernel-launch calls per step, and the kernels that take
             the most.
5. paged     the same model behind ``Engine(max_slots=8, max_seq=2048,
             paged=True, page_size=128, prefix_cache=True)`` and
             ``serve_async``: 16 greedy HTTP requests from 8 client threads
             (half streamed), a shared 1024-token prefix plus a 16-256-token
             suffix each, 64 new tokens each. Every answer must hold 64
             tokens (a stream the same as its final answer), the paged
             kernel pair must run n_layers times per decode forward and the
             contiguous pair never, 15 of the 16 requests must reuse the
             prefix, and after the drain every page must be free or hold a
             cached block. Then ``torch.profiler`` over 3 paged decode
             forwards at the traffic's final lengths, and paged and
             contiguous decode forwards in turns at the same lengths. Last,
             teacher forcing: each answer fed back through the contiguous
             cache with the kernels; every served token must lie within
             1e-1 of max|logit| of the maximum logit at its position (greedy
             streams are not compared token for token: a token's rounding
             depends on the chunk and the tile that computed it), and no
             answer read in another request's context may pass.
6. model     one prefill and 4 decode steps at full width with the kernels
             (kernel_mode "auto") and with the plain versions ("xla"), with
             the kernels over a paged pool, and with the kernels again (the
             run-to-run spread the paged difference is read against).
   kv4       the same params over the int4 head-pair cache: slots
             prefilled to 100-2000 tokens and 4 decode steps, kernels
             against plain and paged against contiguous logits (5e-2 of
             max|logit|); then 8 requests of 32-1024 prompt tokens, 32 new
             each, served in process by the contiguous and the paged engine
             (page 128): exactly 32 kv4 decode and 32 kv4 fused insert
             launches a decode forward, no decode on the plain attention
             path, a profile of 3 B=8 decode forwards, every served token
             teacher-forced, peak device memory beside the int8 phase's.
7. convert   full-width Llama-3-8B (32 layers) from a Hugging Face
             directory: random bf16 weights made on the card from seed 0,
             written as ``*.safetensors`` (16 GB), ``python -m
             quant_tpu_torch convert`` (int4, g128; the C++ coder is
             required), the checkpoint loaded on the card; layer 0's wqkv,
             w_gate_up and w_down and lm_head byte-equal to
             ``quantize_tensor_device`` of their source tensors, and their
             codes unpacked by ``unpack_int4_device`` equal to the host
             codec's (the launches counted); the first 512-token window of
             README.md with the kernels against the plain versions (logits
             within 5e-2 of max|logit|, mean NLL within 1e-2); then ``eval``
             over 4 windows of 512 and ``generate`` on two prompts, each in
             its own process. It prints the write, convert, load and eval
             times and each process's peak RSS.
8. moe       full-width Mixtral-8x7B (the Llama-3-8B params freed first)
             over HTTP from the paged, prefix-cached engine: 8 requests
             from 4 client threads, a shared 512-token prefix plus 16-128
             suffix tokens, 32 new tokens each; exact launch counts (2 x 32
             ``dequant_matmul_moe`` and 2 x 32 + 1 ``dequant_matmul`` per
             forward), 7 prefix hits, every page free or cached, a profile
             of 3 B=8 decode forwards, teacher forcing on the served
             experts. Then one slot (the routed path: a hot list at every
             decode step), and one prefill and 4 decode steps at B=4 with
             the kernels, the plain versions, and the kernels with
             ``moe_routed`` "on" and "off". Then full-width Qwen3-30B-A3B
             in process: 8 requests of 64-256 prompt tokens, 16 new tokens,
             hot lists at every decode step, teacher forcing, kernels
             against plain. A MoE model's comparisons hold every token to
             the experts one pass kept (``held_routing``), and its random
             routers are scaled to unit gain (``unit_gain_router``).
9. deepseek  full-width DeepSeek-V2-Lite (27 layers: MLA, 64 experts top-6,
             2 shared experts, one dense-prefix layer) over HTTP from
             ``Engine(max_slots=8, max_seq=2048)``: 8 requests of 64-1024
             prompt tokens, 64 new tokens each, 4 client threads (half
             streamed); exact launch counts (27 of each MLA kernel per
             decode forward, every insert fused, every decode on the
             tensor-core path, hot lists at decode), a profile of 3 decode
             forwards (one MLA decode and one fused insert kernel a layer,
             no merge kernel; device kernels per step), every answer
             teacher-forced through
             the plain path with the served experts held. Then
             DeepSeek-V3 at full width
             and 4 layers (3 dense-prefix, 1 of 256 experts; low-rank q,
             sigmoid group-limited routing with a bias, 128 heads) in
             process: 4 requests of 128 prompt and 8 new tokens, launch
             counts, kernels against plain logits with the experts held.
             Both random models get unit-gain routers and unit-gain
             attention (``unit_gain_attention``: as drawn, their scores
             amplify rounding differences too much to compare two paths).
             On each, kernels against plain at a 5-8 token context, with a
             planted control (the MLA kernel told each length less one)
             that must fail the same comparison.
10. gemma    full-width Gemma-2-9B (42 layers, random INT4 g128 weights
             from seed 0 made on the card): slots prefilled to 1500-5200
             tokens one at a time, then 4 decode steps at B=4, kernels
             against plain logits (5e-2 of max|logit|); then 8 greedy
             requests (two prompts past the 4096-token window) served in
             process by ``Engine(max_slots=8, max_seq=6144)``, contiguous
             and paged (page 128): exact launch counts (one fused insert
             and one decode kernel a layer and decode forward, 21 of them
             windowed and all softcapped, every matmul on a tensor-core
             tile and every attention call on the tc path), a profile of
             3 B=8 decode forwards at the final lengths, and every served
             token teacher-forced (no answer read in another request's
             context may pass). Then kernels against plain logits on
             Qwen2-7B, Mistral-7B (also paged against contiguous, past its
             window) and Gemma-7B at full width and 4 layers, and
             Gemma-3-1B whole (local and global layers); and Llama-3-8B at
             4 layers with the unquantized cache (``kv_bits=16``, the
             plain decode path), paged against contiguous; and one T=1
             step of DeepSeek-V2-Lite at full width and 2 layers over the
             unquantized latent cache (the plain MLA path: finite logits,
             no MLA kernel launched).
11. cli      (its checks at once, 6 at a time; each runs processes of its
             own) ``python -m quant_tpu_torch generate`` on test-tiny,
             test-tiny-moe, test-tiny-mla and test-tiny-dsv3 checkpoints
             written by the port, and on test-tiny with ``--kv-bits 4``; ``serve --paged`` on the first two (two
             /generate requests over HTTP) and, refused with "not ported",
             on the two MLA ones; ``convert`` of tiny random HF directories
             of the test-tiny (Llama), test-tiny-moe (Mixtral) and
             test-tiny-dsv3 (DeepSeek-V3) shapes, each loaded and run once;
             ``selftest`` (codes bit-exact against the C++ oracle).

Before the last line it prints ``{"kernels": [...]}`` and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
``--detail PATH`` writes the per-shape details as JSON (also when a phase
fails).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, 700 W (data sheet)
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
L2_BYTES = 50 * 2 ** 20

# Llama-3-8B projections: (K, N, launches per forward, out_dtype that
# ``llama.forward`` gives): wqkv, wo, w_gate_up, w_down, lm_head
BF16, F32 = torch.bfloat16, torch.float32
DMM_SHAPES = [(4096, 6144, 32, BF16), (4096, 4096, 32, F32),
              (4096, 28672, 32, BF16), (14336, 4096, 32, F32),
              (4096, 131072, 1, F32)]
# MoE experts: (E, (K, N) of one expert's gate|up, (K, N) of its down with K
# padded as llama.init_params pads it, group size)
MOE_SHAPES = {"mixtral-8x7b": (8, (4096, 28672), (14336, 4096), 128),
              "qwen3-30b-a3b": (128, (2048, 1536), (1024, 2048), 128),
              "deepseek-v2-lite": (64, (2048, 2816), (2048, 2048), 64),
              "deepseek-v3": (256, (7168, 4096), (2048, 7168), 128)}
# DeepSeek-V2-Lite projections at group size 64: (K, N, launches per
# forward, out_dtype the forward gives): wqkv (q | c_kv | k_pe), wo, the
# shared experts' gate|up and down (26 MoE layers), the dense prefix's
# gate|up and down (1 layer), lm_head
DSV2_SHAPES = [(2048, 3648, 27, BF16), (2048, 2048, 27, F32),
               (2048, 5632, 26, BF16), (2816, 2048, 26, F32),
               (2048, 21888, 1, BF16), (10944, 2048, 1, F32),
               (2048, 102400, 1, F32)]
# DeepSeek-V3 projections at group size 128, launches per forward at the
# smoke's 4 layers (3 dense-prefix, 1 MoE): wqkv (q_a | c_kv | k_pe), w_q_b,
# wo, the shared expert's gate|up and down, the dense prefix's gate|up and
# down, lm_head
DSV3_SHAPES = [(7168, 2112, 4, BF16), (1536, 24576, 4, BF16),
               (16384, 7168, 4, F32), (7168, 4096, 1, BF16),
               (2048, 7168, 1, F32), (7168, 36864, 3, BF16),
               (18432, 7168, 3, F32), (7168, 129280, 1, F32)]
# the decode attention rows' context: B=8, S=2048, 8014 tokens
ATT_LENGTHS = [1, 100, 517, 1024, 1500, 2047, 2048, 777]
REPLACES = {
    "dequant_matmul": "quant_tpu/kernels/dequant_matmul.py:312",
    "dequant_matmul_moe": "quant_tpu/kernels/dequant_matmul.py:385",
    "cache_insert_int8": "quant_tpu/kernels/cache_insert.py:131",
    "flash_decode_int8": "quant_tpu/kernels/attention.py:166",
    "paged_cache_insert_int8": "quant_tpu/kernels/cache_insert.py:307",
    "paged_flash_decode_int8": "quant_tpu/kernels/paged_attention.py:145",
    "mla_cache_insert_int8": "quant_tpu/kernels/cache_insert.py:469",
    "mla_flash_decode_int8": "quant_tpu/kernels/mla_attention.py:86",
    "unpack_int4_device": "quant_tpu/kernels/unpack.py:37",
}
SOURCES = {
    "dequant_matmul": "quant_tpu_torch/csrc/dequant_matmul.cu",
    "dequant_matmul_moe": "quant_tpu_torch/csrc/dequant_matmul.cu",
    "cache_insert_int8": "quant_tpu_torch/csrc/cache_insert.cu",
    "flash_decode_int8": "quant_tpu_torch/csrc/flash_decode.cu",
    "paged_cache_insert_int8": "quant_tpu_torch/csrc/cache_insert.cu",
    "paged_flash_decode_int8": "quant_tpu_torch/csrc/flash_decode.cu",
    "mla_cache_insert_int8": "quant_tpu_torch/csrc/cache_insert.cu",
    "mla_flash_decode_int8": "quant_tpu_torch/csrc/mla_attention.cu",
    "unpack_int4_device": "quant_tpu_torch/csrc/unpack.cu",
}
# depth of the converted full-width Llama-3-8B (all of it: the HF directory
# and the packed checkpoint take 20.6 GB of the temporary disk's 74.7 GiB)
CONVERT_LAYERS = 32
# unpack_int4_device: (K, N) of 512x512 random codes and Llama-3-8B's
# w_gate_up and lm_head (padded vocab)
UNPACK_SHAPES = [(512, 512), (4096, 28672), (4096, 131072)]


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def rotating(make, nbytes: int) -> list:
    """Enough copies of an operand that cycling through them exceeds the L2
    cache twice: each timed launch reads its weights from device memory, as
    a decode step does."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def cycle(items):
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


# ── phases ──────────────────────────────────────────────────────────────


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {line}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": line}


def phase_build(detail: dict) -> None:
    from quant_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    wall = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu {r['seconds']:.1f}s ({len(regs)} ptxas "
            f"lines)")
    log(f"[build] all sources in {wall:.1f}s (parallel nvcc)")
    detail["build"] = {"wall_s": wall, **{
        n: {"seconds": r["seconds"], "ptxas": r["log"]}
        for n, r in report.items()}}


def _rand_qt(gen, dev, k, n, bits, g=128):
    from quant_tpu_torch.core.qtensor import QTensor

    kp = k // 2 if bits == 4 else k
    codes = torch.randint(0, 256, (kp, n), generator=gen, device=dev,
                          dtype=torch.int16)
    codes = (codes.to(torch.uint8) if bits == 4
             else (codes - 128).clamp_(-127, 127).to(torch.int8))
    scales = torch.rand((k // g, n), generator=gen, device=dev) * 0.02 + 1e-3
    return QTensor(codes=codes, scales=scales, bits=bits, group_size=g,
                   shape=(k, n))


def served_tile(kernel: str) -> str:
    """The tile that served the one launch of ``kernel`` since the last
    reset of the counters."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.dequant_matmul import TILES

    tiles = [t for t in TILES if _build.launches[f"{kernel}[{t}]"]]
    if len(tiles) != 1 or _build.launches[kernel] != 1:
        raise AssertionError(f"{kernel}: one launch expected, counted "
                             f"{_build.launches[kernel]} over tiles {tiles}")
    return tiles[0]


def dmm_row(gen, bits: int, m: int, k: int, n: int, odt, g: int,
            per: int) -> dict:
    """dequant_matmul at one shape against its plain version (bf16 x), with
    the tile that served it, its device time (weights rotated L2-cold),
    event time, plain time and bound. The bf16 outputs take the kernel's
    bf16 stores and are held against the plain version rounded to bf16 the
    same way. ``dense_bf16_ms`` beside it: torch.matmul of the same bf16 x
    with the weights dequantized to bf16 ahead of time (the prefill target;
    not the same function, never called by the port). ``per``: the shape's
    launches per decode step of its model."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul, dequant_matmul_reference)
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    dev = torch.device("cuda")
    qt = _rand_qt(gen, dev, k, n, bits, g)
    x = torch.randn((m, k), generator=gen, device=dev).to(BF16)
    ref = dequant_matmul_reference(x, qt, odt).float()
    _build.reset_launches()
    got = dequant_matmul(x, qt, out_dtype=odt)
    torch.cuda.synchronize()
    tile = served_tile("dequant_matmul")
    if got.dtype != odt:
        raise AssertionError(f"dequant_matmul gave {got.dtype}, not {odt}")
    err = float((got.float() - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= 2e-2:
        raise AssertionError(f"dequant_matmul int{bits} g{g} M={m} {k}x{n} "
                             f"{odt}: error {rel:.3g} of max|ref| > 2e-2")
    wbytes = qt.codes.numel() + qt.scales.numel() * 4
    qts = [qt] + rotating(lambda: _rand_qt(gen, dev, k, n, bits, g),
                          wbytes)[1:]
    nxt = cycle(qts)
    iters = max(8, len(qts))
    ms, ev = kernel_times(lambda: dequant_matmul(x, nxt(), out_dtype=odt),
                          iters)
    plain = device_time(lambda: dequant_matmul_reference(x, nxt(), odt),
                        iters)
    dense_w = [q.dequantize(BF16) for q in qts[:math.ceil(
        2 * L2_BYTES / (k * n * 2))]]
    nxt_w = cycle(dense_w)
    dense = device_time(lambda: torch.matmul(x, nxt_w()), iters)
    del dense_w
    b_ms, b_by = bound_ms(m * k * 2 + wbytes + m * n * got.element_size(),
                          2 * m * k * n)
    dt_name = str(odt)[6:]
    log(f"[kernels] dequant_matmul int{bits} g{g} M={m:<3d} {k}x{n} -> "
        f"{dt_name} [{tile}]: err {rel:.2e} of max|ref|  {ms:.4f} ms (events "
        f"{ev:.4f})  plain {plain:.4f} ms  dense_bf16 {dense:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by}), {per} launches per decode step")
    return {"kernel": "dequant_matmul", "bits": bits, "group_size": g,
            "M": m, "K": k, "N": n, "out_dtype": dt_name, "tile": tile,
            "max_abs_err": err, "launches_per_step": per,
            "rel_err": rel, "ms": ms, "event_ms": ev, "plain_ms": plain,
            "dense_bf16_ms": dense, "bound_ms": b_ms, "bound_by": b_by,
            "pct_of_bound": 100 * b_ms / ms}


def phase_kernels(detail: dict) -> dict:
    from quant_tpu_torch.kernels.attention import (
        flash_decode_int8, flash_decode_int8_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, summary = [], {}

    # times: device_time sums the profiler's kernel events (no host enqueue,
    # no launch gaps); cuda_time puts CUDA events around back-to-back calls,
    # where the host's enqueue shows whenever it is slower than the kernel.
    # dequant_matmul, int4 at decode and prefill M with the out_dtype the
    # forward gives each projection; int8 at one shape.
    cases = [(4, m, k, n, per, odt) for m in (1, 8, 512)
             for k, n, per, odt in DMM_SHAPES]
    cases += [(4, 64, 4096, 6144, 0, BF16)]       # a short prefill chunk
    cases += [(8, 8, 4096, 4096, 0, F32), (8, 8, 4096, 6144, 0, BF16)]
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    for bits, m, k, n, per, odt in cases:
        row = dmm_row(gen, bits, m, k, n, odt, 128, per)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])
        if bits == 4 and m == 8:
            step["ms"] += per * row["ms"]
            step["plain_ms"] += per * row["plain_ms"]
            step["bound_ms"] += per * row["bound_ms"]
    summary["dequant_matmul"] = {
        "max_abs_err": max_err, **step, "bound_by": "bytes",
        "library_ms": None,
        "unit": "one decode step at B=8: 32 x (4096x6144 bf16 out + "
                "4096x4096 f32 + 4096x28672 bf16 + 14336x4096 f32) + "
                "4096x131072 f32, int4 g128, bf16 x; device time, weights "
                "L2-cold"}

    # decode attention pair at B=8, Hkv=8, rep=4, Dh=128, S=2048, 32 layers
    L, B, H, S, D, rep = 32, 8, 8, 2048, 128, 4
    lengths = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device=dev)
    cache = rand_cache(gen, L, B, H, S, D)
    layer = 5
    detail["plain_scalar_division"] = plain_division_check(dev)
    # the fused RoPE + K/V quantize + insert: contiguous, then the page
    # pools at pages 128 (the serving phase's) and 16
    summary["cache_insert_int8"] = fused_row(gen, cache, lengths, layer)
    rows.append({"kernel": "cache_insert_int8",
                 **summary["cache_insert_int8"]})
    for page in (128, 16):
        pool, tbl, _ = page_pool(cache, lengths, page)
        row = fused_row(gen, pool, lengths, layer, tbl)
        del pool
        torch.cuda.empty_cache()
        rows.append({"kernel": "paged_cache_insert_int8", "page": page,
                     **row})
        if page == 128:
            summary["paged_cache_insert_int8"] = row

    n_tok = int(lengths.clamp(max=S).sum())
    sdpa = sdpa_time(cache, lengths, rep)
    att = {}
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn((B, H * rep, D), generator=gen, device=dev).to(qdt)
        att[str(qdt)] = decode_row(
            "flash_decode_int8",
            lambda q, i: flash_decode_int8(q, *cache, lengths, i),
            lambda q, i: flash_decode_int8_reference(q, *cache, lengths, i),
            q, tol, layer, L, n_tok, H, sdpa,
            f"B=8 Hkv=8 rep=4 D=128 S=2048 ctx={n_tok}")
        att[str(qdt)].pop("out")
    summary["flash_decode_int8"] = {
        **att["torch.bfloat16"], "library_ms": None,
        "unit": f"one call, bf16 q: B=8, Hkv=8, rep=4, Dh=128, S=2048, "
                f"lengths {lengths.tolist()}; device time, each call on "
                f"the next layer of the 32-layer stack (L2-cold)"}
    rows.append({"kernel": "flash_decode_int8", "per_dtype": att})
    for page in (128, 512):
        rows.append(paged_kernels(gen, summary, cache, lengths, layer, page,
                                  {**att, "sdpa": sdpa}))
    del cache
    torch.cuda.empty_cache()
    rows += attention_rows(gen)
    windowed, summary["windowed"] = window_rows(gen)
    rows += windowed
    kv4, summary["kv4"] = kv4_rows(gen)
    rows += kv4
    detail["kernels"] = rows
    return summary


def _rand_stack(gen, dev, entries: int, k: int, n: int, g=128):
    """A random int4 stack [entries, K/2, N] of expert weights."""
    from quant_tpu_torch.core.qtensor import QTensor

    codes = torch.randint(0, 256, (entries, k // 2, n), generator=gen,
                          device=dev, dtype=torch.int16).to(torch.uint8)
    scales = (torch.rand((entries, k // g, n), generator=gen, device=dev)
              * 0.02 + 1e-3)
    return QTensor(codes=codes, scales=scales, bits=4, group_size=g,
                   shape=(k, n))


def _hot_lists(e: int, n_hot: int, dev) -> list:
    """Hot lists [n_hot, ids..., last id repeated] over windows of n_hot
    experts shifted by n_hot each: timed calls cycle through them, so each
    launch streams experts the launch before did not (L2-cold)."""
    out = []
    for r in range(max(1, e // n_hot)):
        ids = sorted((r * n_hot + j) % e for j in range(n_hot))
        out.append(torch.tensor([n_hot] + ids + [ids[-1]] * (e - n_hot),
                                dtype=torch.int32, device=dev))
    return out


def moe_kernels(gen, detail: dict) -> dict:
    """dequant_matmul_moe against its plain version at the Mixtral-8x7B,
    Qwen3-30B-A3B, DeepSeek-V2-Lite (64 experts, down K padded 1408 -> 2048,
    group size 64) and DeepSeek-V3 (256 experts of 7168 x 2048) expert
    shapes, with the out dtype the forward gives each projection (bf16
    gate|up concat, f32 down psum): all experts at decode and prefill M,
    and hot lists of n_hot experts (V2-Lite at B=8 holds about 35 of 64
    hot, V3 at B=4 at most 32 of 256). Each output comes out of
    a NaN-filled block of the caching allocator, and in psum the x rows of
    the slots past n_hot are NaN: a hot call must not read them, and its
    concat tail must be exactly zero. Bound: the bytes of the n_hot slots'
    codes and scales plus x and the output, or their operations at the bf16
    peak. Returns the per-step summary of a Mixtral B=8 decode step (32
    layers of all-experts concat and psum at M=8)."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul_moe, dequant_matmul_moe_reference)
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    dev = torch.device("cuda")
    nan = float("nan")
    cases = [("mixtral-8x7b", mode, m, None)
             for mode in ("concat", "psum") for m in (1, 8, 512)]
    cases += [("mixtral-8x7b", mode, m, h) for m in (1, 4)
              for h in (2, 4, 8) for mode in ("concat", "psum")]
    cases += [("qwen3-30b-a3b", mode, 8, h) for h in (None, 8, 52, 128)
              for mode in ("concat", "psum")]
    cases += [("deepseek-v2-lite", mode, m, h)
              for m, h in ((8, None), (512, None), (8, 6), (8, 35), (8, 64))
              for mode in ("concat", "psum")]
    cases += [("deepseek-v3", mode, m, h)
              for m, h in ((4, None), (512, None), (4, 8), (4, 32))
              for mode in ("concat", "psum")]
    stacks, rows = {}, []
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    for model, mode, m, n_hot in cases:
        t_row = time.perf_counter()
        e, gu, dn, g = MOE_SHAPES[model]
        k, n = gu if mode == "concat" else dn
        if (model, mode) not in stacks:
            if any(key[0] != model for key in stacks):
                stacks.clear()
                torch.cuda.empty_cache()
            stacks[model, mode] = _rand_stack(gen, dev, e, k, n, g)
        qt = stacks[model, mode]
        odt = BF16 if mode == "concat" else F32
        nh = e if n_hot is None else n_hot
        x = torch.randn((m, k) if mode == "concat" else (e, m, k),
                        generator=gen, device=dev).to(BF16)
        if mode != "concat":
            x[nh:] = nan
        hots = _hot_lists(e, nh, dev) if n_hot is not None else [None]
        nxt = cycle(hots)
        kw = dict(n_experts=e, stride=1, mode=mode, out_dtype=odt)
        ref = dequant_matmul_moe_reference(x, qt, 0, hot=hots[0], **kw)
        ref = ref.float()
        width = e * n if mode == "concat" else n
        blk = torch.full((m, width), nan, dtype=odt, device=dev)
        ptr = blk.data_ptr()
        del blk
        _build.reset_launches()
        got = dequant_matmul_moe(x, qt, 0, hot=hots[0], **kw)
        torch.cuda.synchronize()
        tile = served_tile("dequant_matmul_moe")
        nan_preset = got.data_ptr() == ptr
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"dequant_matmul_moe {model} {mode} M={m} "
                                 f"n_hot={nh}: non-finite output")
        if mode == "concat" and bool(got.view(m, e, n)[:, nh:].any()):
            raise AssertionError(f"dequant_matmul_moe {model} concat M={m} "
                                 f"n_hot={nh}: the tail is not zero")
        err = float((got.float() - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= 2e-2:
            raise AssertionError(f"dequant_matmul_moe {model} {mode} M={m} "
                                 f"n_hot={nh}: error {rel:.3g} of max|ref| "
                                 "> 2e-2")
        max_err = max(max_err, err)
        w_bytes = qt.codes[0].numel() + qt.scales[0].numel() * 4
        x_bytes = m * k * 2 * (1 if mode == "concat" else nh)
        b_ms, b_by = bound_ms(nh * w_bytes + x_bytes
                              + m * width * got.element_size(),
                              2 * m * k * n * nh)
        # a call of a millisecond or more needs no average over 8 calls;
        # the plain version (one launch or more per expert, 0.4-290 ms a
        # call) is averaged over 2: its trace's events, not its calls, set
        # the wall time of a row
        iters = max(2 if b_ms >= 1.0 else 8, len(hots))
        ms, ev = kernel_times(lambda: dequant_matmul_moe(x, qt, 0, hot=nxt(),
                                                         **kw), iters)
        plain = device_time(lambda: dequant_matmul_moe_reference(
            x, qt, 0, hot=nxt(), **kw), 2)
        del ref, got, x
        rows.append({"kernel": "dequant_matmul_moe", "model": model,
                     "mode": mode, "M": m, "K": k, "N": n, "experts": e,
                     "n_hot": nh, "hot_list": n_hot is not None,
                     "out_dtype": str(odt)[6:], "tile": tile,
                     "max_abs_err": err,
                     "rel_err": rel, "nan_preset_output": nan_preset,
                     "ms": ms, "event_ms": ev, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "pct_of_bound": 100 * b_ms / ms, "library_ms": None,
                     "wall_s": time.perf_counter() - t_row})
        log(f"[kernels] dequant_matmul_moe {model} {mode} M={m:<3d} {k}x{n} "
            f"x{e} n_hot={nh}{' (hot list)' if n_hot else ''} [{tile}]: err "
            f"{rel:.2e} of max|ref|  {ms:.4f} ms (events {ev:.4f})  plain "
            f"{plain:.4f} ms  bound {b_ms:.4f} ms ({b_by}); row in "
            f"{rows[-1]['wall_s']:.1f}s")
        if model == "mixtral-8x7b" and m == 8 and n_hot is None:
            step["ms"] += 32 * ms
            step["plain_ms"] += 32 * plain
            step["bound_ms"] += 32 * b_ms
    stacks.clear()
    torch.cuda.empty_cache()
    detail["moe_kernels"] = rows
    return {"max_abs_err": max_err, **step, "bound_by": "bytes",
            "library_ms": None,
            "unit": "one Mixtral-8x7B decode step at B=8: 32 x (all 8 "
                    "experts' gate|up concat 4096x28672 bf16 out + down "
                    "psum 14336x4096 f32 out), int4 g128, bf16 x; device "
                    "time, weights L2-cold"}


def page_pool(cache, lengths, page: int):
    """The rows of a contiguous cache ``[L, B, H, S, ..]`` (codes or
    scales, each with its own head count) in a pool ``[L, 1 + B * S / page,
    H, page, ..]`` under a page table shuffled from seed 0, entries past
    each slot's pages on the scratch page 0: (pool tensors, table, table
    entries in use)."""
    dev = cache[0].device
    L, B, _, S = cache[0].shape[:4]
    max_pages = S // page
    n_pool = 1 + B * max_pages
    used = [-(-int(n) // page) for n in lengths.tolist()]
    perm = np.random.default_rng(0).permutation(np.arange(1, n_pool))
    tbl_np = np.zeros((B, max_pages), np.int32)
    for b, u in enumerate(used):
        tbl_np[b, :u] = perm[b * max_pages:b * max_pages + u]
    pool = []
    for a in cache:
        p = torch.zeros((L, n_pool, a.shape[2], page) + tuple(a.shape[4:]),
                        dtype=a.dtype, device=dev)
        for b, u in enumerate(used):
            for j in range(u):
                p[:, tbl_np[b, j]] = a[:, b, :, j * page:(j + 1) * page]
        pool.append(p)
    return pool, torch.from_numpy(tbl_np).to(dev), sum(used)


def _sdpa_time(q, kv: list, mask, gqa: bool) -> dict:
    """``torch.nn.functional.scaled_dot_product_attention`` of ``q`` over
    each (K, V) of ``kv`` in turn (``mask`` or none; ``enable_gqa``), on the
    first backend of flash, cuDNN, memory-efficient and math that takes the
    call: its device time and the backend."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from quant_tpu_torch.utils.timing import device_time

    nxt = cycle(kv)

    def call():
        k, v = nxt()
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=gqa)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                call()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel([backend]):
            ms = device_time(call, max(8, len(kv)))
        return {"sdpa_bf16_ms": ms, "sdpa_backend": backend.name}
    raise RuntimeError("no scaled_dot_product_attention backend took the "
                       "call")


def _length_mask(lengths, s: int, window: int = 0):
    """[B, 1, 1, S] True below each slot's length (and, with a window, at or
    past ``length - window``); None when every position is visible."""
    pos = torch.arange(s, device=lengths.device)[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask = mask & (pos >= lengths[:, None] - window)
    if bool(mask.all()):
        return None
    return mask[:, None, None, :]


def sdpa_time(cache, lengths, rep: int, window: int = 0) -> dict:
    """The yardstick beside each decode-attention row:
    ``torch.nn.functional.scaled_dot_product_attention`` with bf16 q over
    the same context dequantized to bf16 ahead of time (``[B, Hkv, S, Dh]``
    K and V, ``enable_gqa``, positions past each length, or before a
    ``window``, masked unless every position is visible), cycling enough
    dequantized layers to exceed the L2 cache twice. Another function than
    the kernel (it reads twice the bytes over all S positions, and takes no
    softcap; an int4 cache is unpacked to its real heads first); the port
    never calls it."""
    from quant_tpu_torch.kernels.rope_kv import dequant_kv4

    kc, ks, vc, vs = cache
    L, B, _, S, D = kc.shape
    H = ks.shape[2]
    per_layer = 2 * B * H * S * D * 2
    n = max(1, min(L, math.ceil(2 * L2_BYTES / per_layer)))
    unpack = dequant_kv4 if kc.dtype == torch.uint8 else (
        lambda c: c.float())
    kv = [((unpack(kc[i]) * ks[i][..., None]).to(BF16),
           (unpack(vc[i]) * vs[i][..., None]).to(BF16)) for i in range(n)]
    q = torch.randn((B, H * rep, 1, D), device=kc.device).to(BF16)
    res = _sdpa_time(q, kv, _length_mask(lengths, S, window), gqa=True)
    del kv
    torch.cuda.empty_cache()
    return res


def mla_sdpa_time(kc, ks, lengths, h: int, r: int) -> dict:
    """The yardstick beside each MLA row: ``scaled_dot_product_attention``
    with bf16 q over the latent rows dequantized to bf16 ahead of time, as
    MQA with the H heads as H query rows of one head (``[B, 1, H, Dq]``):
    K the whole rows (Dk = Dq), V their first r lanes (Dv = r), all S
    positions under the length mask, cycling enough layers to exceed the L2
    cache twice. Another function than the kernel (it reads K and V apart,
    over all S positions); the port never calls it."""
    L, B, _, S, D = kc.shape
    n = max(1, min(L, math.ceil(2 * L2_BYTES / (B * S * (D + r) * 2))))
    kv = []
    for i in range(n):
        k = (kc[i].float() * ks[i][..., None]).to(BF16)
        kv.append((k, k[..., :r].contiguous()))
    q = torch.randn((B, 1, h, D), device=kc.device).to(BF16)
    res = _sdpa_time(q, kv, _length_mask(lengths, S), gqa=False)
    del kv
    torch.cuda.empty_cache()
    return res


def decode_row(name: str, kernel, plain, q, tol: float, layer: int,
               layers: int, n_tok: int, hkv: int, sdpa: dict, what: str,
               extra_bytes: int = 0, work: tuple | None = None,
               kv4: bool = False) -> dict:
    """One decode-attention row: ``kernel(q, layer)`` against
    ``plain(q, layer)`` (``tol`` of max|ref|), one launch counted under the
    path it should take (tc for bf16 q; over the int4 cache, ``kv4``, also
    under [kv4]), a second call bit-equal to the first, then its device
    time (each call on the next layer of the ``layers``-deep stack,
    L2-cold), the plain version's, the bound of ``n_tok`` tokens' K/V codes
    (Dh bytes a token and real head each for K and V, Dh / 2 at int4) and
    scales (plus ``extra_bytes``; or ``work``, the call's (bytes,
    operations)), and ``sdpa`` beside them."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    qdt = q.dtype
    path = "tc" if qdt == BF16 else "cuda_core"
    _build.reset_launches()
    got = kernel(q, layer)
    if not (_build.launches[name] == _build.launches[f"{name}[{path}]"] == 1
            and _build.launches.get(f"{name}[kv4]", 0) == int(kv4)):
        raise AssertionError(f"{name} ({qdt}): one launch on the {path} path "
                             f"expected, counted {_build.launches}")
    again = kernel(q, layer)
    ref = plain(q, layer).float()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} gave non-finite values")
    err = float((got.float() - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= tol:
        raise AssertionError(f"{name} {what} ({qdt}): error {rel:.3g} of "
                             f"max|ref| > {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {what} ({qdt}): two calls on the same "
                             "inputs differ")
    nxt = cycle(range(layers))
    iters = max(8, layers)
    ms, ev = kernel_times(lambda: kernel(q, nxt()), iters)
    plain_ms = device_time(lambda: plain(q, nxt()), iters)
    b, hq, d = q.shape
    nbytes = (2 * b * hq * d * q.element_size()
              + n_tok * hkv * ((d if kv4 else 2 * d) + 8) + b * 4 + extra_bytes)
    b_ms, b_by = bound_ms(*(work or (nbytes, 4 * n_tok * hq * d)))
    log(f"[kernels] {name} {str(qdt)[6:]} {what} [{path}"
        f"{', kv4' if kv4 else ''}]: err {rel:.2e} of "
        f"max|ref|, rerun bit-equal  {ms:.4f} ms (events {ev:.4f})  plain "
        f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
        f"{100 * b_ms / ms:.0f}%)  sdpa_bf16 {sdpa['sdpa_bf16_ms']:.4f} ms "
        f"({sdpa['sdpa_backend']})")
    return {"max_abs_err": err, "rel_err": rel, "path": path, "ms": ms,
            "event_ms": ev, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "pct_of_bound": 100 * b_ms / ms, **sdpa,
            "rerun_bit_equal": True, "out": got}


def paged_rows(gen, cache, lengths, layer: int, page: int, rep: int,
               sdpa: dict, what: str) -> dict:
    """``paged_flash_decode_int8`` over ``cache``'s rows in a page pool
    (:func:`page_pool`) against its plain version (1e-4 of max|ref| with
    f32 q, 1e-2 with bf16 q) and against the contiguous kernel on the same
    rows."""
    from quant_tpu_torch.kernels.attention import flash_decode_int8
    from quant_tpu_torch.kernels.paged_attention import (
        paged_attention_reference, paged_flash_decode_int8)

    L, B, _, S, D = cache[0].shape
    H, kv4 = cache[1].shape[2], cache[0].dtype == torch.uint8
    pool, tbl, n_used = page_pool(cache, lengths, page)
    n_tok = int(lengths.clamp(max=S).sum())
    att = {}
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn((B, H * rep, D), generator=gen,
                        device=cache[0].device).to(qdt)
        row = decode_row(
            "paged_flash_decode_int8",
            lambda q, i: paged_flash_decode_int8(q, *pool, tbl, lengths, i),
            lambda q, i: paged_attention_reference(q, *pool, tbl, lengths,
                                                   i),
            q, tol, layer, L, n_tok, H, sdpa, f"page={page} {what}",
            extra_bytes=4 * n_used, kv4=kv4)
        contig = flash_decode_int8(q, *cache, lengths, layer)
        row["max_abs_diff_vs_contiguous"] = float(
            (row.pop("out").float() - contig.float()).abs().max())
        log(f"[kernels]   |paged - contiguous| <= "
            f"{row['max_abs_diff_vs_contiguous']:.2e}")
        att[str(qdt)] = row
    del pool
    torch.cuda.empty_cache()
    return att


def paged_kernels(gen, summary: dict, cache, lengths, layer: int,
                  page: int, contiguous: dict) -> dict:
    """Paged flash decode at the decode shape of the kernels phase, over a
    32-layer pool holding the contiguous cache's rows under a page table
    shuffled from seed 0 (entries past each slot's pages on the scratch
    page 0), as :func:`paged_rows`, beside the contiguous kernel's time."""
    att = paged_rows(gen, cache, lengths, layer, page, 4, contiguous["sdpa"],
                     "B=8 Hkv=8 rep=4 D=128 S=2048")
    for qdt, row in att.items():
        row["contiguous_ms"] = contiguous[qdt]["ms"]
    if page == 128:     # the serving phase's page size
        summary["paged_flash_decode_int8"] = {
            **att["torch.bfloat16"], "library_ms": None,
            "unit": f"one call, bf16 q: B=8, Hkv=8, rep=4, Dh=128, page "
                    f"128, 16-page tables, lengths {lengths.tolist()}; "
                    f"device time, each call on the next layer of the "
                    f"32-layer pool (L2-cold)"}
    return {"kernel": "paged_flash_decode_int8", "page": page,
            "attention": att}


def plain_division_check(dev) -> dict:
    """How the plain quantizer's ``absmax / 127.0`` (int8) and ``absmax /
    7.0`` (int4) round on this card: PyTorch's CUDA division by a Python
    scalar may multiply by the f32 reciprocal instead of dividing. Counts,
    over 2^20 random values, the quotients that differ from ``x * fl(1/d)``
    and from an IEEE division (a tensor divisor); the fused kernel
    multiplies by the reciprocal."""
    x = torch.rand(1 << 20, generator=torch.Generator(device=dev).manual_seed(
        0), device=dev) * 16
    res = {"values": x.numel()}
    for d in (127.0, 7.0):
        got = x / d
        inv = float(torch.tensor(1.0) / torch.tensor(d))   # f32 reciprocal
        tag = str(int(d))
        res[f"differ_from_reciprocal_mul_{tag}"] = int((got != x * inv).sum())
        res[f"differ_from_ieee_div_{tag}"] = int(
            (got != x / torch.full_like(x, d)).sum())
        log(f"[kernels] plain absmax / {d} on the card: "
            f"{res[f'differ_from_reciprocal_mul_{tag}']} of {res['values']} "
            f"differ from x * fl(1/{tag}), "
            f"{res[f'differ_from_ieee_div_{tag}']} from an IEEE division")
    return res


def fused_row(gen, cache, lengths, layer: int, tbl=None) -> dict:
    """The fused RoPE + K/V quantize + insert at Llama-3-8B's B=8 decode
    shapes: q, k and v bf16 views of one random ``wqkv`` output row (Hq 32,
    Hkv 8, Dh 128), the model's llama3 rope tables at the slots' lengths,
    into ``cache`` (a 32-layer stack, or a page pool under ``tbl``). Codes
    and scales byte-equal to the plain chain (RoPE, ``quantize_kv``, the
    codes-in insert) and the rotated q bit-equal, one launch counted under
    [fused]; then its device time (each call on the next layer, L2-cold),
    the plain chain's device time, and the bound of the bytes the call must
    move (q, k, v, the tables, the lengths and table entries read; q and
    the rows of the slots whose position lies in the cache written). A
    uint8 ``cache`` is the int4 head-pair cache (``kv_bits=4``, counted
    under [kv4] too)."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.cache_insert import (
        cache_insert_int8_fused, cache_insert_int8_fused_reference,
        paged_cache_insert_int8_fused,
        paged_cache_insert_int8_fused_reference)
    from quant_tpu_torch.models import PRESETS, llama
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    cfg = PRESETS["llama-3-8b"]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev, layers, b = cache[0].device, cache[0].shape[0], lengths.shape[0]
    paged = tbl is not None
    name = "paged_cache_insert_int8" if paged else "cache_insert_int8"
    kernel, plain = ((paged_cache_insert_int8_fused,
                      paged_cache_insert_int8_fused_reference) if paged else
                     (cache_insert_int8_fused,
                      cache_insert_int8_fused_reference))
    kv4 = cache[0].dtype == torch.uint8
    extra = (tbl,) if paged else ()
    kw = {"kv_bits": 4} if kv4 else {}
    row = torch.randn((b, 1, (hq + 2 * hkv) * dh), generator=gen,
                      device=dev).to(BF16)
    q = row[..., :hq * dh].view(b, 1, hq, dh)
    k = row[..., hq * dh:(hq + hkv) * dh].view(b, 1, hkv, dh)
    v = row[..., (hq + hkv) * dh:].view(b, 1, hkv, dh)
    cos, sin = llama._rope_tables(lengths[:, None], cfg.rope_theta, dh, cfg)
    ref_cache = [t.clone() for t in cache]
    _build.reset_launches()
    got = kernel(q, k, v, cos, sin, *cache, lengths, layer, *extra, **kw)
    ref = plain(q, k, v, cos, sin, *ref_cache, lengths, layer, *extra, **kw)
    torch.cuda.synchronize()
    what = (f"{name} page {cache[0].shape[3]}" if paged else name) + (
        " kv4" if kv4 else "")
    if (_build.launches[name] != 1 or _build.launches[f"{name}[fused]"] != 1
            or _build.launches[f"{name}[kv4]"] != int(kv4)):
        raise AssertionError(f"{what}: one launch under [fused] expected, "
                             f"counted {_build.launches}")
    if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(f"{what}: q is not bit-equal to the plain "
                             "chain's")
    for a, r in zip(cache, ref_cache):
        if not torch.equal(a.view(torch.int8), r.view(torch.int8)):
            raise AssertionError(f"{what}: the cache is not byte-equal to "
                                 "the plain chain's")
    del ref_cache
    nxt = cycle(range(layers))
    ms, ev = kernel_times(lambda: kernel(q, k, v, cos, sin, *cache, lengths,
                                         nxt(), *extra, **kw), layers)
    plain_ms = device_time(lambda: plain(q, k, v, cos, sin, *cache, lengths,
                                         nxt(), *extra, **kw), layers)
    cap = tbl.shape[1] * cache[0].shape[3] if paged else cache[0].shape[3]
    written = int(((lengths >= 0) & (lengths < cap)).sum())
    nbytes = (row.numel() * 2 + 2 * cos.numel() * 4 + b * 4 * (1 + paged)
              + b * hq * dh * 2
              + written * 2 * hkv * ((dh // 2 if kv4 else dh) + 4))
    b_ms, b_by = bound_ms(nbytes, 0)
    where = (f"page {cache[0].shape[3]}, {layers}-layer pool of "
             f"{cache[0].shape[1]} pages" if paged
             else f"S={cache[0].shape[3]}, {layers}-layer stack")
    log(f"[kernels] {name} [fused{', kv4' if kv4 else ''}] B=8 Hq=32 "
        f"Hkv=8 D=128 bf16 {where}: "
        f"codes and scales byte-equal, q bit-equal  {ms:.4f} ms (events "
        f"{ev:.4f})  plain chain {plain_ms:.4f} ms  bound {b_ms:.6f} ms "
        f"({b_by}, {nbytes} bytes)")
    return {"max_abs_err": 0.0, "ms": ms, "event_ms": ev,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "library_ms": None,
            "unit": f"one call, RoPE + K/V quantize + insert fused"
                    f"{' into the int4 head-pair cache' if kv4 else ''}: "
                    f"B=8, Hq=32, Hkv=8, Dh=128, bf16 q/k/v views of one "
                    f"wqkv row, {where}, lengths {lengths.tolist()}; device "
                    f"time"}


def rand_cache(gen, layers: int, b: int, hkv: int, s: int, d: int) -> list:
    """A random int8 K/V cache stack and its f32 scales on the card."""
    dev = torch.device("cuda")

    def codes():
        return torch.randint(-127, 128, (layers, b, hkv, s, d), generator=gen,
                             device=dev, dtype=torch.int16).to(torch.int8)

    def scales():
        return torch.rand((layers, b, hkv, s), generator=gen,
                          device=dev) * 0.015 + 0.005
    return [codes(), scales(), codes(), scales()]


def rand_cache4(gen, layers: int, b: int, hkv: int, s: int, d: int) -> list:
    """A random int4 head-pair K/V cache on the card: uint8 codes of
    ``hkv / 2`` packed heads (every nibble value) and f32 scales of ``hkv``
    real heads, the values about the int8 cache's."""
    dev = torch.device("cuda")

    def codes():
        return torch.randint(0, 256, (layers, b, hkv // 2, s, d),
                             generator=gen, device=dev,
                             dtype=torch.int16).to(torch.uint8)

    def scales():
        return torch.rand((layers, b, hkv, s), generator=gen,
                          device=dev) * 0.24 + 0.08
    return [codes(), scales(), codes(), scales()]


# the kv4 Gemma-2-9B local row: 2 layers (one layer's 134 MB of codes is
# past twice the L2 cache), the int8 row's shape, window and softcap
KV4_WINDOW_ROWS = [("gemma-2-9b local kv4", 2, 8, 2, 256, 4096, 50.0,
                    1 / 16)]


def kv4_rows(gen) -> tuple[list, dict]:
    """The int4 head-pair cache (``kv_bits=4``) through both fused inserts
    and both decode kernels at the int8 rows' Llama-3-8B shapes: the
    inserts at B=8 into the 32-layer cache and its pool at page 128
    (:func:`fused_row`: codes and scales byte-equal to the plain chain);
    decode at Hkv=8, rep=4 over the 8014-token lengths (32 layers) and 8
    slots of 8192 tokens (2 layers), contiguous and paged at page 128, f32
    and bf16 q (:func:`decode_row`: 1e-4 / 1e-2 of max|ref|, rerun
    bit-equal, one launch under [kv4], each bound counting Dh bytes of K and
    V codes a token and real head and the scales); and Gemma-2-9B's local
    layer (Dh=256, rep=2, window 4096, softcap 50). Returns the rows and
    the kernels line's four kv4 entries (bf16 decode at 8014 tokens, the
    inserts)."""
    from quant_tpu_torch.kernels.attention import (
        flash_decode_int8, flash_decode_int8_reference)

    rows, summary = [], {}
    for L, S, lens, layer in ((32, 2048, ATT_LENGTHS, 5),
                              (2, 8192, [8192] * 8, 1)):
        B, H, D, rep = 8, 8, 128, 4
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cache = rand_cache4(gen, L, B, H, S, D)
        long = S == 8192
        if not long:
            summary["cache_insert_int8"] = fused_row(gen, cache, lengths,
                                                     layer)
            pool, tbl, _ = page_pool(cache, lengths, 128)
            summary["paged_cache_insert_int8"] = fused_row(
                gen, pool, lengths, layer, tbl)
            del pool
            torch.cuda.empty_cache()
            for name in ("cache_insert_int8", "paged_cache_insert_int8"):
                rows.append({"kernel": name, "kv4": True, **summary[name]})
        n_tok = int(lengths.sum())
        what = (f"kv4 B=8 Hkv=8 rep=4 D=128 S={S}"
                f"{' (long context)' if long else ''} ctx={n_tok}")
        sdpa = sdpa_time(cache, lengths, rep)
        att = {}
        for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q = torch.randn((B, H * rep, D), generator=gen,
                            device="cuda").to(qdt)
            att[str(qdt)] = decode_row(
                "flash_decode_int8",
                lambda q, i: flash_decode_int8(q, *cache, lengths, i),
                lambda q, i: flash_decode_int8_reference(q, *cache, lengths,
                                                         i),
                q, tol, layer, L, n_tok, H, sdpa, what, kv4=True)
            att[str(qdt)].pop("out")
        paged = paged_rows(gen, cache, lengths, layer, 128, rep, sdpa, what)
        rows += [{"kernel": "flash_decode_int8", "kv4": True, "rows": what,
                  "per_dtype": att},
                 {"kernel": "paged_flash_decode_int8", "kv4": True,
                  "rows": what, "page": 128, "per_dtype": paged}]
        if not long:
            unit = (f"one call over the int4 head-pair cache, bf16 q: B=8, "
                    f"Hkv=8, rep=4, Dh=128, lengths {lens}")
            summary["flash_decode_int8"] = {
                **att["torch.bfloat16"], "library_ms": None,
                "unit": f"{unit}, S=2048; device time, each call on the next "
                        f"layer of the 32-layer stack (L2-cold)"}
            summary["paged_flash_decode_int8"] = {
                **paged["torch.bfloat16"], "library_ms": None,
                "unit": f"{unit}, page 128, 16-page tables; device time, "
                        f"each call on the next layer of the 32-layer pool "
                        f"(L2-cold)"}
        del cache
        torch.cuda.empty_cache()
    windowed, _ = window_rows(gen, KV4_WINDOW_ROWS, kv4=True)
    return rows + windowed, summary


def attention_rows(gen) -> list:
    """Decode attention at Qwen3-30B-A3B's heads (Hkv=4, rep=8) over the
    smoke's lengths and a 32-layer stack, and at long context: 8 slots of
    8192 tokens over a 2-layer stack (268 MB of codes, over twice the L2
    cache), contiguous and paged at page 128."""
    from quant_tpu_torch.kernels.attention import (
        flash_decode_int8, flash_decode_int8_reference)

    rows = []
    for what, L, B, H, S, rep, lens, pages in (
            ("B=8 Hkv=4 rep=8 D=128 S=2048", 32, 8, 4, 2048, 8, ATT_LENGTHS,
             ()),
            ("B=8 Hkv=8 rep=4 D=128 S=8192 (long context)", 2, 8, 8, 8192,
             4, [8192] * 8, (128,))):
        cache = rand_cache(gen, L, B, H, S, 128)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n_tok = int(lengths.sum())
        sdpa = sdpa_time(cache, lengths, rep)
        att = {}
        for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q = torch.randn((B, H * rep, 128), generator=gen,
                            device="cuda").to(qdt)
            att[str(qdt)] = decode_row(
                "flash_decode_int8",
                lambda q, i: flash_decode_int8(q, *cache, lengths, i),
                lambda q, i: flash_decode_int8_reference(q, *cache, lengths,
                                                         i),
                q, tol, L - 1, L, n_tok, H, sdpa, f"{what} ctx={n_tok}")
            att[str(qdt)].pop("out")
        rows.append({"kernel": "flash_decode_int8", "rows": what,
                     "per_dtype": att})
        for page in pages:
            rows.append({"kernel": "paged_flash_decode_int8", "rows": what,
                         "page": page, "per_dtype": paged_rows(
                             gen, cache, lengths, L - 1, page, rep, sdpa,
                             what)})
        del cache
        torch.cuda.empty_cache()
    return rows


def mla_rows(gen, kc, ks, lengths, layer: int, r: int, scale: float,
             heads: tuple, kv_dim: int, what: str, key: str = "") -> dict:
    """``mla_flash_decode_int8`` rows over one latent cache stack: at each
    of ``heads``, f32 q (CUDA cores, 1e-4 of max|ref|) and bf16 q (tensor
    cores, 1e-2), each through :func:`decode_row` (path counted, rerun
    bit-equal, device time L2-cold, plain version), q's lanes past
    ``kv_dim`` zero as the model pads them. Bound: q, the context's latent
    rows and scales, the lengths and the output once, or 2 H (Dq + r)
    operations a token at the bf16 peak. ``sdpa_bf16_ms`` beside each
    (:func:`mla_sdpa_time`)."""
    from quant_tpu_torch.kernels.mla_attention import (
        mla_flash_decode_int8, mla_flash_decode_int8_reference)

    L, B, _, S, D = kc.shape
    n_tok = int(lengths.clamp(max=S).sum())
    att = {}
    for h in heads:
        sdpa = mla_sdpa_time(kc, ks, lengths, h, r)
        for qdt, tol in ((F32, 1e-4), (BF16, 1e-2)):
            q = torch.randn((B, h, D), generator=gen, device=kc.device).to(qdt)
            q[..., kv_dim:] = 0          # the padded lanes, as in use
            qb = q.element_size()
            work = (B * h * D * qb + n_tok * (D + 4) + B * 4 + B * h * r * qb,
                    2 * n_tok * h * (D + r))
            row = decode_row(
                "mla_flash_decode_int8",
                lambda q, i: mla_flash_decode_int8(q, kc, ks, lengths, i,
                                                   r=r, scale=scale),
                lambda q, i: mla_flash_decode_int8_reference(
                    q, kc, ks, lengths, i, r=r, scale=scale),
                q, tol, layer, L, n_tok, 1, sdpa,
                f"{what} H={h} ctx={n_tok}", work=work)
            row.pop("out")
            att[f"{key}H={h} {str(qdt)[6:]}"] = row
    return att


def fused_mla_row(gen, kc, ks, lengths, cfg, agree: dict) -> dict:
    """The fused MLA latent insert (RMSNorm of c, interleaved yarn RoPE of
    k_pe and q_pe, the latent row quantized and inserted, q_eff written) at
    ``cfg``'s widths and B=8 into the latent cache ``kc`` / ``ks`` (27
    layers, S=2048): ckv and q_pe bf16 views of one random down-projection
    row (V2-Lite), or q_pe a view of a separate ``w_q_b`` output row (V3's
    low-rank q), q_abs the einsum with a random bf16 ``w_uk`` as the model
    computes it, the model's rope tables at the slots' lengths. q_eff
    bit-equal to the plain chain's and the latent byte-equal, or every code
    within 1 and every scale within 2^-7 relative (the RMSNorm's sum is
    taken in another order than ATen's): ``agree`` adds up the written and
    the differing codes over the smoke's rows. One launch counted under
    [fused]; then its device time (each call on the next layer's rows),
    event time, the plain chain's device time, and the bound of the bytes
    the call must move (q_abs, q_pe, ckv, the gain, tables and lengths
    read; q_eff and the rows of the slots whose position lies in the cache
    written)."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.cache_insert import (
        mla_cache_insert_int8_fused, mla_cache_insert_int8_fused_reference)
    from quant_tpu_torch.models import llama
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    dev, (L, B, _, S, D) = kc.device, kc.shape
    h, r, dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, qw = cfg.qk_nope_head_dim, cfg.n_heads * cfg.head_dim
    akv = torch.randn((B, 1, (cfg.q_lora_rank or qw) + r + dr),
                      generator=gen, device=dev).to(BF16)
    q_src = (torch.randn((B, 1, qw), generator=gen, device=dev).to(BF16)
             if cfg.q_lora_rank else akv[..., :qw])
    qh = q_src.view(B, 1, h, dn + dr)
    ckv, q_pe = akv[..., -(r + dr):], qh[..., dn:]
    w_uk = (torch.randn((h, dn, r), generator=gen, device=dev)
            / math.sqrt(dn)).to(BF16)
    q_abs = torch.einsum("bthn,hnr->bthr", qh[..., :dn], w_uk)
    w = 1.0 + 0.1 * torch.randn(r, generator=gen, device=dev)
    rope = llama._rope_tables(lengths[:, None], cfg.rope_theta, dr, cfg)
    opts = dict(llama._rope_options(cfg), eps=cfg.norm_eps)
    layer = 5
    ref_c = [kc.clone(), ks.clone()]
    _build.reset_launches()
    got = mla_cache_insert_int8_fused(ckv, q_pe, q_abs, w, *rope, kc, ks,
                                      lengths, layer, **opts)
    ref = mla_cache_insert_int8_fused_reference(ckv, q_pe, q_abs, w, *rope,
                                                *ref_c, lengths, layer,
                                                **opts)
    torch.cuda.synchronize()
    what = f"mla_cache_insert_int8 [fused] H={h}"
    if (_build.launches["mla_cache_insert_int8"] != 1
            or _build.launches["mla_cache_insert_int8[fused]"] != 1):
        raise AssertionError(f"{what}: one launch under [fused] expected, "
                             f"counted {_build.launches}")
    if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError(f"{what}: q_eff is not bit-equal to the plain "
                             "chain's")
    written = int(((lengths >= 0) & (lengths < S)).sum())
    for a, b in zip((kc, ks), ref_c):
        if not (torch.equal(a[:layer], b[:layer])
                and torch.equal(a[layer + 1:], b[layer + 1:])):
            raise AssertionError(f"{what}: a layer other than {layer} "
                                 "changed")
    kl, sl, rkl, rsl = kc[layer], ks[layer], ref_c[0][layer], ref_c[1][layer]
    d = (kl.int() - rkl.int()).abs()
    differ = int((d > 0).sum())
    scale_rel = float(((sl - rsl).abs() / rsl).max())
    # the dequantized latent of the two caches' layer
    err = float((kl.float() * sl[..., None] - rkl.float()
                 * rsl[..., None]).abs().max())
    log(f"[kernels] {what}: q_eff bit-equal; {differ} of {written * D} "
        f"written latent codes differ (max {int(d.max())}), scales within "
        f"{scale_rel:.3g} relative")
    if int(d.max()) > 1 or scale_rel > 2.0 ** -7:
        raise AssertionError(f"{what}: latent codes differ by more than 1 "
                             "or scales by more than 2^-7 relative")
    agree["codes"] = agree.get("codes", 0) + written * D
    agree["differ"] = agree.get("differ", 0) + differ
    del ref_c, d
    nxt = cycle(range(L))
    ms, ev = kernel_times(lambda: mla_cache_insert_int8_fused(
        ckv, q_pe, q_abs, w, *rope, kc, ks, lengths, nxt(), **opts), L)
    plain_ms = device_time(lambda: mla_cache_insert_int8_fused_reference(
        ckv, q_pe, q_abs, w, *rope, kc, ks, lengths, nxt(), **opts), L)
    nbytes = (2 * B * h * (r + dr) + 2 * B * (r + dr) + 4 * r
              + 2 * rope[0].numel() * 4 + B * 4 + 2 * B * h * D
              + written * (D + 4))
    b_ms, b_by = bound_ms(nbytes, 0)
    where = (f"B=8 H={h} r={r} dr={dr} Dq={D} bf16, {L}-layer latent "
             f"cache S={S}")
    log(f"[kernels] mla_cache_insert_int8 [fused] {where}: {ms:.4f} ms "
        f"(events {ev:.4f})  plain "
        f"chain {plain_ms:.4f} ms  bound {b_ms:.6f} ms ({b_by}, {nbytes} "
        f"bytes)")
    return {"max_abs_err": err, "codes_differ": differ,
            "codes_written": written * D, "max_scale_rel": scale_rel,
            "ms": ms, "event_ms": ev, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": None,
            "unit": f"one call, RMSNorm + RoPE + latent quantize + insert + "
                    f"q_eff fused: {where}, ckv and q_pe bf16 views of the "
                    f"projection rows, lengths {lengths.tolist()}; device "
                    f"time, each call on the next layer's rows"}


def mla_kernels(gen, detail: dict) -> dict:
    """The MLA pair over a DeepSeek latent cache: 27 layers, B=8, S=2048,
    rows of Dq=640 int8 lanes (576 used) and one scale each, the attention
    rows' lengths (8014 tokens, one slot at capacity). The fused latent
    insert (:func:`fused_mla_row`) at DeepSeek-V2-Lite's widths (H=16) and
    DeepSeek-V3's (H=128, low-rank q), at most 1e-3 of the written codes
    differing over both rows; ``mla_flash_decode_int8`` with r=512 at H=16
    and H=128 (:func:`mla_rows`), and at H=16 over 8 slots of 8192 tokens on
    a 4-layer stack. Then dequant_matmul at the V2-Lite shapes, int4 in
    groups of 64, and at the V3 shapes in groups of 128."""
    from quant_tpu_torch.models import PRESETS
    from quant_tpu_torch.models.llama import _q_scale

    dev = torch.device("cuda")
    v2 = PRESETS["deepseek-v2-lite"]
    L, B, S, D, r = v2.n_layers, 8, 2048, v2.mla_cache_dim, v2.kv_lora_rank
    scale = _q_scale(v2, v2.head_dim)
    lengths = torch.tensor(ATT_LENGTHS, dtype=torch.int32, device=dev)
    kc = torch.randint(-127, 128, (L, B, 1, S, D), generator=gen, device=dev,
                       dtype=torch.int16).to(torch.int8)
    ks = torch.rand((L, B, 1, S), generator=gen, device=dev) * 0.015 + 0.005
    layer = 5
    agree: dict = {}
    inserts = {f"H={c.n_heads}": fused_mla_row(gen, kc, ks, lengths, c,
                                               agree)
               for c in (v2, PRESETS["deepseek-v3"])}
    share = agree["differ"] / agree["codes"]
    log(f"[kernels] mla_cache_insert_int8 [fused]: {agree['differ']} of "
        f"{agree['codes']} written latent codes differ from the plain "
        f"chain's ({share:.2e})")
    if share > 1e-3:
        raise AssertionError("mla_cache_insert_int8 [fused]: more than 1e-3 "
                             "of the written latent codes differ")
    summary = {"mla_cache_insert_int8": {
        **inserts["H=16"], "max_abs_err": max(
            row["max_abs_err"] for row in inserts.values())}}
    att = mla_rows(gen, kc, ks, lengths, layer, r, scale, (16, 128),
                   v2.mla_kv_dim, f"B=8 Dq={D} r={r} S=2048")
    summary["mla_flash_decode_int8"] = {
        **att["H=16 bfloat16"], "library_ms": None,
        "unit": f"one call, bf16 q: B=8, H=16, Dq={D}, r={r}, S=2048, "
                f"lengths {ATT_LENGTHS}; device time, each call on the next "
                f"layer of the {L}-layer latent cache (L2-cold)"}
    del kc, ks
    torch.cuda.empty_cache()
    # long context: 8 slots of 8192 tokens over a 4-layer stack (168 MB,
    # past twice the L2 cache), H=16
    kc = torch.randint(-127, 128, (4, B, 1, 8192, D), generator=gen,
                       device=dev, dtype=torch.int16).to(torch.int8)
    ks = torch.rand((4, B, 1, 8192), generator=gen,
                    device=dev) * 0.015 + 0.005
    long_len = torch.full((B,), 8192, dtype=torch.int32, device=dev)
    att.update(mla_rows(gen, kc, ks, long_len, 3, r, scale, (16,),
                        v2.mla_kv_dim, f"B=8 Dq={D} r={r} S=8192 (long "
                        "context)", key="8x8192 "))
    del kc, ks
    torch.cuda.empty_cache()
    mm_rows = []
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for m in (1, 8, 512):
        for k, n, per, odt in DSV2_SHAPES:
            row = dmm_row(gen, 4, m, k, n, odt, 64, per)
            mm_rows.append(row)
            if m == 8:
                for key in step:
                    step[key] += per * row[key]
    log(f"[kernels] dequant_matmul, one DeepSeek-V2-Lite B=8 decode step's "
        f"dense projections (int4 g64): {step['ms']:.3f} ms, plain "
        f"{step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms")
    # DeepSeek-V3 at the smoke's depth: decode at B=4, a prefill chunk
    v3_rows = [dmm_row(gen, 4, m, k, n, odt, 128, per) for m in (4, 512)
               for k, n, per, odt in DSV3_SHAPES]
    detail["mla_kernels"] = {"insert": inserts, "insert_codes": agree,
                             "attention": att, "dsv2_matmul": mm_rows,
                             "dsv2_matmul_step_m8": step,
                             "dsv3_matmul": v3_rows}
    return summary


def unpack_kernels(gen, detail: dict) -> dict:
    """``unpack_int4_device`` against its plain version and the host codec
    (the C++ oracle's ``unpack_int4`` read as the split-K layout), bit for
    bit, at ``UNPACK_SHAPES``: 512x512 random codes packed by the numpy
    codec (unpacked, they must give the codes back), then random bytes at
    Llama-3-8B's ``w_gate_up`` and ``lm_head`` shapes; device time with the
    operands rotated L2-cold, the plain version's time and the byte bound
    (K/2·N read, K·N written)."""
    from quant_tpu_torch.core import codec, oracle
    from quant_tpu_torch.kernels.unpack import (unpack_int4_device,
                                                unpack_int4_host,
                                                unpack_int4_reference)
    from quant_tpu_torch.utils.timing import device_time, kernel_times

    if not oracle.available():
        raise RuntimeError("the C++ oracle (cpp/quantref.cpp) did not build")
    dev = torch.device("cuda")
    rows = []
    for k, n in UNPACK_SHAPES:
        def rand_packed():
            return torch.randint(0, 256, (k // 2, n), generator=gen,
                                 device=dev, dtype=torch.int16).to(
                                     torch.uint8)
        codes = None
        if (k, n) == (512, 512):
            codes = np.random.default_rng(0).integers(-8, 8, (k, n)).astype(
                np.int8)
            packed = torch.from_numpy(codec.pack_int4_matmul(codes)).to(dev)
        else:
            packed = rand_packed()
        got = unpack_int4_device(packed)
        ref = unpack_int4_reference(packed)
        torch.cuda.synchronize()
        host = unpack_int4_host(packed.cpu().numpy())
        got_np = got.cpu().numpy()
        if not (torch.equal(got, ref) and np.array_equal(got_np, host)
                and (codes is None or np.array_equal(got_np, codes))):
            raise AssertionError(f"unpack_int4_device {k}x{n} is not "
                                 "bit-exact against its plain version and "
                                 "the host codec")
        m = packed.numel()
        ops = [packed] + rotating(rand_packed, m)[1:]
        nxt = cycle(ops)
        iters = max(8, len(ops))
        ms, ev = kernel_times(lambda: unpack_int4_device(nxt()), iters)
        plain = device_time(lambda: unpack_int4_reference(nxt()), iters)
        b_ms, b_by = bound_ms(3 * m, 0)
        log(f"[kernels] unpack_int4_device {k}x{n}: bit-exact (plain, host "
            f"codec)  {ms:.4f} ms (events {ev:.4f})  plain {plain:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
        rows.append({"kernel": "unpack_int4_device", "K": k, "N": n,
                     "max_abs_err": 0.0, "ms": ms, "event_ms": ev,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                     "pct_of_bound": 100 * b_ms / ms})
        del ops, got, ref
    detail["unpack"] = rows
    torch.cuda.empty_cache()
    head = rows[-1]
    return {k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by")} | {
        "library_ms": None,
        "unit": "one call at lm_head's 4096x131072 (268 MB packed); device "
                "time, operand L2-cold"}


def phase_serving(detail: dict, params, cfg) -> dict:
    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.kernels import _build

    eng = Engine(params, cfg, max_slots=8, max_seq=2048, eos_id=-1,
                 device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 1025, 8)
    reqs = [Request(req_id=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, n)], max_new_tokens=64) for i, n in
        enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    calls = []
    while eng.has_work():
        c0 = time.perf_counter()
        chunks0, dec0 = eng.prefill_chunks, eng.decode_forwards
        eng.step_block(16)
        torch.cuda.synchronize()
        calls.append({"s": time.perf_counter() - c0,
                      "chunks": eng.prefill_chunks - chunks0,
                      "decode": eng.decode_forwards - dec0})
    total = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not all(r.finished and len(r.output) == 64 for r in reqs):
        raise AssertionError("not every request finished with 64 tokens")
    expect = {
        "dequant_matmul": (4 * cfg.n_layers + 1)
        * (eng.prefill_chunks + eng.decode_forwards),
        "cache_insert_int8": cfg.n_layers * eng.decode_forwards,
        "cache_insert_int8[fused]": cfg.n_layers * eng.decode_forwards,
        "flash_decode_int8": cfg.n_layers * eng.decode_forwards,
    }
    for k, v in expect.items():
        if launches[k] != v or v == 0:
            raise AssertionError(f"{k}: {launches[k]} launches, expected {v}")
    check_tiles("serving", launches)
    pure = [c for c in calls if c["chunks"] == 0 and c["decode"]]
    decode_ms = (1e3 * sum(c["s"] for c in pure)
                 / max(1, sum(c["decode"] for c in pure)))
    first = calls[0]
    prefill_s = first["s"] - first["decode"] * decode_ms / 1e3
    ttfts = sorted(r.ttft for r in reqs)
    out = {
        "prompt_lens": lens.tolist(), "prompt_tokens": int(lens.sum()),
        "prefill_chunks": eng.prefill_chunks,
        "decode_forwards": eng.decode_forwards, "launches": launches,
        "expected_launches": expect, "total_s": total,
        "prefill_s_est": prefill_s,
        "prefill_tokens_per_s_est": float(lens.sum()) / prefill_s,
        "decode_ms_per_step": decode_ms,
        "decode_tokens_per_s": 8 * 1e3 / decode_ms,
        "tokens_per_s": 8 * 64 / total,
        "ttft_ms_p50": 1e3 * ttfts[len(ttfts) // 2],
        "ttft_ms_max": 1e3 * ttfts[-1],
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "step_block_calls": calls, "stats": eng.stats,
    }
    log(f"[serving] 8 requests, prompts {lens.tolist()} -> 64 tokens each; "
        f"{eng.prefill_chunks} prefill chunks, {eng.decode_forwards} decode "
        f"steps; launches {launches} (expected {expect})")
    log(f"[serving] prefill ~{prefill_s * 1e3:.0f} ms for {int(lens.sum())} "
        f"tokens, decode {decode_ms:.2f} ms/step (B=8), "
        f"{out['tokens_per_s']:.1f} tok/s overall, TTFT p50 "
        f"{out['ttft_ms_p50']:.0f} ms max {out['ttft_ms_max']:.0f} ms, "
        f"max_memory_allocated {out['max_memory_allocated_gib']:.2f} GiB")
    out["profile"] = profile_decode(eng)
    detail["serving"] = out
    return out


_HTTP = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_json(url: str, payload=None, timeout: float = 600):
    """GET (payload None) or POST JSON to a local server, bypassing any
    proxy settings; returns the decoded JSON body."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with _HTTP.open(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_stream(url: str, payload, timeout: float = 600):
    """POST a streaming /generate; returns (concatenated token_ids, the
    final "done" object)."""
    req = urllib.request.Request(
        url, data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    toks = []
    with _HTTP.open(req, timeout=timeout) as r:
        for raw in r:
            obj = json.loads(raw)
            if obj.get("done"):
                return toks, obj
            toks += obj["token_ids"]
    raise AssertionError("stream ended without its done line")


def http_traffic(eng, prompts, n_new: int, clients: int,
                 model_name: str) -> dict:
    """Every prompt as a greedy /generate request of ``n_new`` tokens to
    ``serve_async`` in front of ``eng``, from ``clients`` threads (client c
    sends requests c, c + clients, ... in turn; the even-numbered ones
    streamed). Every answer must hold ``n_new`` tokens, and a stream the same
    tokens as its final answer. Returns the answers, the launch counts (reset
    just before the traffic), each scheduler step on the host clock (each
    ends in a device sync: the sampled tokens come back to the host), the
    most pages in use, the admitted Request objects (for their TTFT), the
    total time, /healthz and the engine's stats."""
    from quant_tpu_torch.engine.server import serve_async
    from quant_tpu_torch.kernels import _build

    steps, held, admitted = [], [0], []
    inner_step, inner_add = eng.step, eng.add_request

    def add_request(req):
        inner_add(req)
        admitted.append(req)

    def timed_step():
        chunks0, dec0 = eng.prefill_chunks, eng.decode_forwards
        t0 = time.perf_counter()
        out = inner_step()
        steps.append({"s": time.perf_counter() - t0,
                      "chunks": eng.prefill_chunks - chunks0,
                      "decode": eng.decode_forwards - dec0})
        st = eng.stats
        held[0] = max(held[0], st.get("total_pages", 0)
                      - st.get("free_pages", 0))
        return out
    eng.step, eng.add_request = timed_step, add_request
    httpd, srv = serve_async(eng, model_name=model_name)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, errors = {}, []

    def client(k):
        try:
            for i in range(k, len(prompts), clients):
                payload = {"prompt_ids": prompts[i], "max_new_tokens": n_new}
                if i % 2 == 0:
                    toks, done = http_stream(base + "/generate", payload)
                    results[i] = {"stream": toks, **done}
                else:
                    results[i] = http_json(base + "/generate", payload)
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(f"client {k}: {e!r}")

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    total = time.perf_counter() - t0
    launches = dict(_build.launches)
    health = http_json(base + "/healthz")
    httpd.shutdown()
    httpd.server_close()
    srv.stop()
    del eng.step, eng.add_request
    if errors or len(results) != len(prompts):
        raise AssertionError(f"{model_name} over HTTP: {len(results)} of "
                             f"{len(prompts)} answers; {errors}")
    for i, r in results.items():
        if len(r["output_ids"]) != n_new or r["timed_out"]:
            raise AssertionError(f"request {i}: {len(r['output_ids'])} "
                                 f"tokens, timed_out {r['timed_out']}")
        if "stream" in r and r["stream"] != r["output_ids"]:
            raise AssertionError(f"request {i}: the stream differs from its "
                                 "final output_ids")
    return {"results": results, "launches": launches, "steps": steps,
            "peak_pages_in_use": held[0], "admitted": admitted,
            "total_s": total, "healthz": health, "stats": eng.stats}


def phase_paged_serving(detail: dict, params, cfg) -> dict:
    """16 greedy requests over HTTP to a paged, prefix-cached engine: a
    shared 1024-token prefix plus a 16-256-token suffix each, 64 new tokens,
    from 8 client threads, half streamed. Then the paged decode step alone
    (profiled, and in turns with a contiguous one), and every served stream
    checked by teacher forcing through the contiguous cache."""
    from quant_tpu_torch.engine import Engine

    n_req, n_new, prefix_len = 16, 64, 1024
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, prefix_len)]
    suffix_lens = rng.integers(16, 257, n_req)
    prompts = [prefix + [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in suffix_lens]
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, max_slots=8, max_seq=2048, eos_id=-1,
                 device="cuda", paged=True, page_size=128, prefix_cache=True)
    c = eng.cache
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        c.k_codes, c.k_scale, c.v_codes, c.v_scale))
    page_bytes = pool_bytes // eng.n_pages
    contiguous_bytes = page_bytes * 8 * 2048 // 128
    traffic = http_traffic(eng, prompts, n_new, 8, "llama-3-8b")
    results, launches = traffic["results"], traffic["launches"]
    steps, stats, total = (traffic["steps"], traffic["stats"],
                           traffic["total_s"])
    held, admitted = traffic["peak_pages_in_use"], traffic["admitted"]
    health = traffic["healthz"]
    fwd = stats["prefill_chunks"] + stats["decode_forwards"]
    expect = {"dequant_matmul": (4 * cfg.n_layers + 1) * fwd,
              "paged_cache_insert_int8":
                  cfg.n_layers * stats["decode_forwards"],
              "paged_cache_insert_int8[fused]":
                  cfg.n_layers * stats["decode_forwards"],
              "paged_flash_decode_int8":
                  cfg.n_layers * stats["decode_forwards"],
              "cache_insert_int8": 0, "flash_decode_int8": 0,
              "dequant_matmul_moe": 0}
    for k, v in expect.items():
        if launches[k] != v or (v == 0 and k.startswith("paged")):
            raise AssertionError(f"paged serving: {k}: {launches[k]} "
                                 f"launches, expected {v}")
    check_tiles("paged serving", launches)
    if stats["prefix_hit_tokens"] != (n_req - 1) * prefix_len:
        raise AssertionError(f"prefix_hit_tokens {stats['prefix_hit_tokens']}"
                             f", expected {(n_req - 1) * prefix_len}")
    if stats["free_pages"] + stats["cached_blocks"] != stats["total_pages"]:
        raise AssertionError(f"after the drain, {stats['free_pages']} free + "
                             f"{stats['cached_blocks']} cached pages of "
                             f"{stats['total_pages']}")
    pure = [s for s in steps if s["decode"] and not s["chunks"]]
    decode_ms = 1e3 * sum(s["s"] for s in pure) / max(1, len(pure))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttfts = sorted(1e3 * r.ttft for r in admitted)
    log(f"[paged] {n_req} HTTP requests (8 clients, half streamed), shared "
        f"{prefix_len}-token prefix + {suffix_lens.min()}-"
        f"{suffix_lens.max()} suffix, {n_new} new tokens each: "
        f"{stats['prefill_chunks']} prefill chunks, "
        f"{stats['decode_forwards']} decode steps; launches {launches} "
        f"(expected {expect})")
    log(f"[paged] prefix_hit_tokens {stats['prefix_hit_tokens']}, after the "
        f"drain {stats['free_pages']} free + {stats['cached_blocks']} cached "
        f"= {stats['total_pages']} pages")
    log(f"[paged] decode {decode_ms:.2f} ms/step, "
        f"{n_req * n_new / total:.1f} tok/s overall, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.0f} ms max {ttfts[-1]:.0f} ms, "
        f"max_memory_allocated {peak_gib:.2f} GiB; pool "
        f"{pool_bytes / 2**20:.0f} MiB (contiguous cache "
        f"{contiguous_bytes / 2**20:.0f} MiB), at most {held} pages "
        f"({held * page_bytes / 2**20:.0f} MiB) in use")
    # the decode step alone, without the server's threads: every slot
    # holds the pages of its last request at its final length
    park_at_lengths(eng, [len(prompts[i]) + n_new for i in range(8, n_req)])
    profile = profile_decode(eng, label="paged decode (page 128)")
    # host time of a B=8 decode forward over the pool and over a contiguous
    # cache at the same lengths, in turns (contiguous, paged, paged,
    # contiguous): the host is shared and its pace drifts within a call
    from quant_tpu_torch.models import llama
    contig = llama.init_cache(cfg, 8, 2048, "cuda")
    contig.lengths.copy_(c.lengths)
    tokens = torch.zeros((8, 1), dtype=torch.int64, device="cuda")

    def forward_ms(cache, n=8):
        llama.forward(params, tokens, cache, cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            _, cache = llama.forward(params, tokens, cache, cfg,
                                     device="cuda")
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n
    turns = [("contiguous", contig), ("paged", c), ("paged", c),
             ("contiguous", contig)]
    ab = [(name, forward_ms(cache)) for name, cache in turns]
    ab_ms = {k: [ms for name, ms in ab if name == k]
             for k in ("contiguous", "paged")}
    log(f"[paged] decode forward B=8 at the same lengths, host clock, in "
        f"turns: contiguous {ab_ms['contiguous']} ms, paged "
        f"{ab_ms['paged']} ms")
    del eng, c, contig, traffic
    torch.cuda.empty_cache()

    tf = teacher_forced(params, cfg, prompts, prefix_len,
                        [results[i]["output_ids"] for i in range(n_req)])
    out = {
        "requests": n_req, "new_tokens": n_new, "prefix_len": prefix_len,
        "suffix_lens": suffix_lens.tolist(),
        "prefill_chunks": stats["prefill_chunks"],
        "decode_forwards": stats["decode_forwards"],
        "launches": launches, "expected_launches": expect,
        "total_s": total, "tokens_per_s": n_req * n_new / total,
        "decode_ms_per_step": decode_ms,
        "ttft_ms_p50": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
        "max_memory_allocated_gib": peak_gib,
        "pool_bytes": pool_bytes, "contiguous_cache_bytes": contiguous_bytes,
        "peak_pages_in_use": held, "page_bytes": page_bytes,
        "teacher_forced": tf, "profile": profile, "decode_ms_turns": ab,
        "stats": stats, "healthz": health, "steps": steps,
    }
    detail["paged_serving"] = out
    return out


# a served token must lie within this share of max|logit| of the
# teacher-forced maximum: twice the model phase's logits limit, since the
# served logits and the teacher-forced ones may each stand 5e-2 from exact
TF_MARGIN = 2 * 5e-2


def teacher_forced(params, cfg, prompts, prefix_len: int, outs,
                   tag: str = "paged", kept: dict | None = None) -> dict:
    """Each served stream fed back through the contiguous cache with the
    kernels (one chunk of its suffix and all but its last token after the
    shared prefix, prefilled once): at each served position, the gap from
    the teacher-forced maximum logit to the served token's, over
    max|logit|. Every served token must be within ``TF_MARGIN``. The
    control reads each answer in the next request's context, as a fault in
    prefix reuse would serve it: no such answer may pass.

    ``kept``: for a MoE model, the experts the serving run kept, keyed by
    (("prefix" or the request's index), position) and layer
    (``held_routing``); the teacher-forced pass keeps the same ones."""
    from quant_tpu_torch.models import llama

    n_new = len(outs[0])
    cur = [None]
    hold = (held_routing(moe_layers(cfg), lambda x: cur[0], kept)
            if kept is not None else contextlib.nullcontext(
                {"swapped": 0, "held": 0, "decisions": 0}))
    with hold as routing:
        cache = llama.init_cache(cfg, 1, 2048, "cuda")
        for a in range(0, prefix_len, 512):
            chunk = prompts[0][a:a + 512]
            cur[0] = [("prefix", a + j) for j in range(len(chunk))]
            _, cache = llama.forward(params, [chunk], cache, cfg,
                                     device="cuda")
        served, wrong, top1 = [], [], 0
        for i, out in enumerate(outs):
            at_prefix = dataclasses.replace(cache, lengths=torch.full(
                (1,), prefix_len, dtype=torch.int32, device="cuda"))
            toks = prompts[i][prefix_len:] + out[:-1]
            cur[0] = [(i, prefix_len + j) for j in range(len(toks))]
            lg, _ = llama.forward(params, [toks], at_prefix, cfg,
                                  device="cuda")
            lg = lg[0, -n_new:]
            top, scale = lg.max(-1).values, lg.abs().max(-1).values

            def gap(toks):
                t = torch.tensor(toks, device="cuda")[:, None]
                return ((top - lg.gather(-1, t)[:, 0]) / scale).tolist()
            served.append(gap(out))
            wrong.append(gap(outs[(i + 1) % len(outs)]))
            top1 += int((lg.argmax(-1).cpu() == torch.tensor(out)).sum())
            del lg
    if routing["held"] != routing["decisions"]:
        raise AssertionError(f"{tag}: {routing['held']} of "
                             f"{routing['decisions']} routing decisions of "
                             "the teacher-forced pass were served")
    flat = [g for gs in wrong for g in gs]
    res = {"limit": TF_MARGIN, "max_gap": max(map(max, served)),
           "routing_held": routing["held"],
           "routing_swapped": routing["swapped"],
           "top1_share": top1 / (len(outs) * n_new),
           "control_passed": sum(max(gs) <= TF_MARGIN for gs in wrong),
           "control_token_share_within": sum(g <= TF_MARGIN for g in flat)
           / len(flat), "control_median_gap": float(np.median(flat))}
    log(f"[{tag}] teacher-forced through the contiguous cache: "
        f"{len(outs) * n_new} served tokens, {res['top1_share']:.3f} of them "
        f"the argmax, largest gap to the max logit {res['max_gap']:.3e} of "
        f"max|logit| (limit {TF_MARGIN}); control, each answer in the next "
        f"request's context: {res['control_passed']} of {len(outs)} pass "
        f"({res['control_token_share_within']:.3f} of tokens within the "
        f"limit, median gap {res['control_median_gap']:.3e})"
        + (f"; routing held to the served experts in {routing['held']} "
           f"(token, layer) decisions, {routing['swapped']} of which would "
           f"have kept others" if kept is not None else ""))
    if not res["max_gap"] <= TF_MARGIN:
        raise AssertionError(f"a served token stands {res['max_gap']:.3g} of "
                             "max|logit| below the teacher-forced maximum")
    if res["control_passed"]:
        raise AssertionError("the teacher-forced check passes answers read "
                             "in the wrong context")
    return res


def profile_decode(eng, steps: int = 3, label: str = "decode",
                   cfg=None) -> dict:
    """Host-clock time of a few decode forwards of all the engine's slots
    over its cache (the slots at their final lengths), with nothing patched
    in, then their device time from ``torch.profiler``: the busy share of the host-clock window, the kernels that take the most
    of it, and the device time of each of the port's kernels (summed over
    its instantiations). ``cfg`` overrides the engine's config."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quant_tpu_torch.models import llama

    tokens = torch.zeros((eng.max_slots, 1), dtype=torch.int64,
                         device="cuda")
    cache = eng.cache

    def step():
        nonlocal cache
        _, cache = llama.forward(eng.params, tokens, cache, cfg or eng.cfg,
                                 device="cuda")
    step()       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()      # the same forwards without the profiler
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same device time again
    by_name, calls, spans, kernels = {}, {}, [], 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tr = e.time_range
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (tr.end - tr.start) / 1e3 / steps)
            calls[e.name] = calls.get(e.name, 0) + 1 / steps
            spans.append((tr.start, tr.end))
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):        # union: overlapping spans count once
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    busy = busy_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    averages = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps,
                    e.count / steps) for e in averages
                   if e.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:12]
    # the CUDA API calls that launch a kernel (cudaLaunchKernel,
    # cuLaunchKernel, ...), per step
    launch_calls = {e.key: e.count / steps for e in averages
                    if "LaunchKernel" in e.key}
    ours = {}
    for name, ms in by_name.items():
        for kernel in ("dequant_matmul_moe_kernel", "dequant_matmul_kernel",
                       "mla_decode", "mla_rope_insert_kernel",
                       "paged_flash_decode", "flash_decode",
                       "rope_kv_insert_kernel"):
            if kernel in name:
                ours[kernel] = ours.get(kernel, 0.0) + ms
                break
    res = {"steps": steps, "batch": eng.max_slots,
           "bare_forward_ms_per_step": bare_ms, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy if busy else "not measured",
           "idle_share": 1 - busy / wall_ms if busy else "not measured",
           "device_kernels_per_step": kernels / steps,
           "launch_calls_per_step": launch_calls,
           "top_kernels_ms_per_step": top, "port_kernels_ms_per_step": ours,
           # every attention kernel of the trace and its launches per
           # step: one per layer and call, no separate merge kernel
           "attention_launches_per_step": {
               n: c for n, c in calls.items() if "flash_decode" in n
               or "mla_decode" in n},
           # every cache-insert kernel and its launches per step: one per
           # layer (the fused GQA or MLA insert)
           "insert_launches_per_step": {
               n: c for n, c in calls.items() if "insert_kernel" in n},
           "top_host_ops_self_cpu_ms_per_step": host}
    log(f"[profile] {label} B={eng.max_slots}: bare forward {bare_ms:.2f} "
        f"ms/step; under torch.profiler {wall_ms:.2f} ms/step "
        f"on the host clock, device busy "
        f"{busy:.2f} ms/step" + (f" (idle share {res['idle_share']:.2f})"
                                 if busy else " (no device time recorded)"))
    log(f"[profile]   {kernels / steps:.1f} device kernels/step; launch "
        f"calls/step {launch_calls}")
    for name, ms in top[:6]:
        log(f"[profile]   device {ms:8.3f} ms/step  {name[:80]}")
    for name, n in res["attention_launches_per_step"].items():
        log(f"[profile]   attention {n:5.1f} launches/step  {name[:80]}")
    for name, ms, calls in host[:6]:
        log(f"[profile]   host   {ms:8.3f} ms/step  {calls:6.0f} calls/step  "
            f"{name[:80]}")
    return res


def phase_model(detail: dict, params, cfg) -> None:
    from quant_tpu_torch.models import llama

    rng = np.random.default_rng(1)
    b, t = 2, 128
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
             for _ in range(4)]
    logits = {}
    # "auto2" repeats "auto": the kernels' run-to-run spread is the
    # yardstick for "paged"
    for mode in ("auto", "xla", "paged", "auto2"):
        c = dataclasses.replace(cfg, kernel_mode="xla" if mode == "xla"
                                else "auto")
        if mode == "paged":
            # two 128-token pages per slot, in shuffled order
            cache = llama.init_paged_cache(c, b, 256, n_pages=1 + 2 * b,
                                           page=128, device="cuda")
            cache.page_tbl.copy_(torch.tensor([[3, 1], [4, 2]]))
        else:
            cache = llama.init_cache(c, b, 256, "cuda")
        outs = []
        lg, cache = llama.forward(params, prompt, cache, c, device="cuda")
        outs.append(lg[:, -1])
        for s in steps:
            lg, cache = llama.forward(params, s, cache, c, device="cuda")
            outs.append(lg[:, -1])
        logits[mode] = torch.stack(outs).float()
        del cache
    a, r = logits["auto"], logits["xla"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite logits")
    rel = float((a - r).abs().max() / r.abs().max())
    agree = float((a.argmax(-1) == r.argmax(-1)).float().mean())
    p = logits["paged"]
    p_rel = float((p - a).abs().max() / a.abs().max())
    p_agree = float((p.argmax(-1) == a.argmax(-1)).float().mean())
    a_rel = float((logits["auto2"] - a).abs().max() / a.abs().max())
    log(f"[model] full-width prefill(T=128) + 4 decode steps, B=2: kernels "
        f"vs plain max|dlogit| = {rel:.3e} of max|logit|, argmax agreement "
        f"{agree:.3f}")
    log(f"[model] paged pool (page 128) vs contiguous cache, both with the "
        f"kernels: max|dlogit| = {p_rel:.3e} of max|logit|, argmax "
        f"agreement {p_agree:.3f}; the contiguous run repeated: "
        f"{a_rel:.3e}")
    detail["model"] = {"rel_err": rel, "argmax_agreement": agree,
                       "paged_rel_err": p_rel,
                       "paged_argmax_agreement": p_agree,
                       "rerun_rel_err": a_rel}
    if not rel <= 5e-2:
        raise AssertionError(f"kernel vs plain logits differ by {rel:.3g}")
    if not (bool(torch.isfinite(p).all()) and p_rel <= 5e-2):
        raise AssertionError(f"paged vs contiguous logits differ by "
                             f"{p_rel:.3g}")


@contextlib.contextmanager
def moe_dispatch():
    """Count the model's ``dequant_matmul_moe`` calls with a hot list
    (routed slots) and without (all experts), by wrapping the function the
    model calls; the kernel's own launch counter is not touched."""
    from quant_tpu_torch.models import llama

    counts = {"hot": 0, "all": 0}
    inner = llama.dequant_matmul_moe

    def spy(*args, **kw):
        counts["hot" if kw.get("hot") is not None else "all"] += 1
        return inner(*args, **kw)
    llama.dequant_matmul_moe = spy
    try:
        yield counts
    finally:
        llama.dequant_matmul_moe = inner


def unit_gain_router(params, cfg) -> None:
    """Scale the random router of ``llama.init_params`` (the JAX package's
    std 0.5: router logits of std 0.5 * sqrt(D), 32 for Mixtral-8x7B) to
    std 1/sqrt(D), logits of std 1, in place, by the std it was drawn with
    (measured here, so the init's constant is known in one place). At std
    0.5 the routing
    weights are a high-gain function of the hidden state: the same forward
    run twice, differing only in the order of its split-K atomics, gave
    logits 0.09 (Mixtral-8x7B) and 0.54 (Qwen3-30B-A3B) of max|logit|
    apart, with the experts held fixed, so no two paths could be compared
    on such weights."""
    router = params.layers.router
    router.mul_(1.0 / (float(router.std()) * math.sqrt(cfg.dim)))


def unit_gain_attention(params, cfg) -> None:
    """Scale the random key up-projection ``w_uk`` of ``llama.init_params``
    (drawn with std 1/sqrt(dn), as the JAX package draws it) so that the
    no-rope part of the attention scores has std 1 at the model's score
    scale, in place, by the std it was drawn with (measured here). As drawn,
    the scores have std sqrt(r) * ``_q_scale``: 2.6 for V2-Lite, 3.1 for
    V3, a sharp softmax over random keys that, with the rounding of the int8
    latent, amplifies a rounding-size difference layer after layer, so the
    kernel and plain paths could not be compared on such weights (see
    PERF.md, Findings). Over hundreds of tokens the scaled softmax is soft,
    so a fault of one token's weight moves those comparisons by about
    1/length: ``mla_fault_check`` compares at a short context, where it
    cannot hide."""
    from quant_tpu_torch.models import llama

    s = llama._q_scale(cfg, cfg.head_dim)
    for lay in (params.layers0, params.layers):
        if lay is not None:
            lay.w_uk.mul_(1.0 / (float(lay.w_uk.float().std()) * s * math.sqrt(
                cfg.qk_nope_head_dim * cfg.kv_lora_rank)))


@contextlib.contextmanager
def planted_mla_fault():
    """The MLA decode kernel as the model calls it, given each slot's length
    less one: the newest latent row, the one the step just inserted, is left
    out, as an off-by-one in the kernel's mask or in its call would leave it
    out."""
    from quant_tpu_torch.models import llama

    inner = llama.mla_flash_decode_int8

    def short(q, kc, ks, lengths, layer, **kw):
        return inner(q, kc, ks, lengths - 1, layer, **kw)
    llama.mla_flash_decode_int8 = short
    try:
        yield
    finally:
        llama.mla_flash_decode_int8 = inner


def mla_fault_check(detail: dict, tag: str, params, cfg) -> None:
    """Kernels against plain at a short context (B=4, a 4-token prefill, 4
    decode steps over 5 to 8 tokens), experts held, within the model limit;
    and the control: the kernels with ``planted_mla_fault`` must stand more
    than that limit from plain, or the comparison could not see a fault of
    one token in the attention."""
    moe_model_check(detail, tag, params, cfg, 4, 4, 4,
                    {"kernels": {}, "plain": {"kernel_mode": "xla"},
                     "planted": {}},
                    [("kernels", "plain")],
                    faults={"planted": planted_mla_fault},
                    controls=[("planted", "plain")])


@contextlib.contextmanager
def held_routing(n_layers: int, rows, kept: dict | None = None):
    """Record the experts ``moe_route`` keeps, or hold a later computation
    to a record. Top-k routing is discontinuous: at a near-tie of two router
    logits, rounding at another place (another kernel split, the order of
    the split-K atomics) keeps the other expert, and the two outputs then
    part by a whole expert's contribution. So a MoE model is compared on the
    experts one pass chose.

    ``rows(x)``, called at each forward's first layer with its input, gives
    a key for each of its token rows (None: not recorded); the calls of a
    forward come in layer order. Without ``kept``, every row's experts are
    recorded (on the device while running; ``state["kept"]`` maps (key,
    layer) to them when the block exits). With ``kept``, rows with a record
    keep the recorded experts, with the weights this computation gives them;
    ``state["held"]`` counts those (row, layer) decisions, of
    ``state["decisions"]``, and ``state["swapped"]`` the held ones that
    would have kept other experts. The held weights are the router's scores
    (softmax or sigmoid) of the held experts, renormalized and scaled as
    ``moe_route`` does; a selection bias and expert groups only choose
    experts, so holding the choice covers them. ``n_layers``: the layers
    that route (a dense prefix does not)."""
    from quant_tpu_torch.models import llama

    inner = llama.moe_route
    state = {"kept": {} if kept is None else kept, "swapped": 0, "held": 0,
             "decisions": 0}
    pending, at = [], {"call": 0, "keys": None}

    def route(x, router, cfg, bias=None):
        w = inner(x, router, cfg, bias)
        layer = at["call"] % n_layers
        at["call"] += 1
        if layer == 0:
            at["keys"] = rows(x)
        own = (w > 0).reshape(-1, w.shape[-1])
        if kept is None:
            pending.append((at["keys"], layer, own))
            return w
        recs = [kept.get((k, layer)) for k in at["keys"]]
        state["decisions"] += len(recs)
        state["held"] += sum(r is not None for r in recs)
        if all(r is None for r in recs):
            return w
        own = own.cpu()
        held = torch.stack([own[i] if r is None else r
                            for i, r in enumerate(recs)])
        state["swapped"] += int((held != own).any(-1).sum())
        logits = x.float() @ router.float()
        probs = (torch.sigmoid(logits) if cfg.score_fn == "sigmoid"
                 else torch.softmax(logits, dim=-1))
        w = probs * held.to(x.device).reshape(w.shape)
        if cfg.norm_topk:
            w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        return w * cfg.routed_scaling
    llama.moe_route = route
    try:
        yield state
    finally:
        llama.moe_route = inner
        for keys, layer, own in pending:
            own = own.cpu()
            for i, k in enumerate(keys):
                if k is not None:
                    state["kept"][k, layer] = own[i]


def moe_layers(cfg) -> int:
    """The layers that route (a DeepSeek dense prefix does not)."""
    return cfg.n_layers - cfg.first_k_dense


def check_tiles(what: str, launches: dict) -> None:
    """Every matmul of a bf16 run took a tensor-core tile: the CUDA-core
    tile served none, and the tiles' counts add up to each kernel's; every
    decode-attention call (GQA and MLA) took the tensor-core path."""
    for k in ("dequant_matmul", "dequant_matmul_moe"):
        tc = launches[f"{k}[tc_decode]"] + launches[f"{k}[tc_prefill]"]
        if launches[f"{k}[cuda_core]"] or tc != launches[k]:
            raise AssertionError(
                f"{what}: {k}: {launches[k]} launches, "
                f"{launches[f'{k}[tc_decode]']} tc_decode + "
                f"{launches[f'{k}[tc_prefill]']} tc_prefill, "
                f"{launches[f'{k}[cuda_core]']} cuda_core")
    for k in ("flash_decode_int8", "paged_flash_decode_int8",
              "mla_flash_decode_int8"):
        if launches[f"{k}[cuda_core]"] or launches[f"{k}[tc]"] != launches[k]:
            raise AssertionError(
                f"{what}: {k}: {launches[k]} launches, "
                f"{launches[f'{k}[tc]']} tc, "
                f"{launches[f'{k}[cuda_core]']} cuda_core")


def check_mla_profile(profile: dict, n_layers: int) -> None:
    """One MLA decode kernel and one fused latent insert kernel, each
    launched once per layer and step, and no separate merge kernel or other
    insert kernel, in a decode profile (the profiler may lose a trace's
    first events, so fewer launches are tolerated, more are not)."""
    att = profile["attention_launches_per_step"]
    ins = profile["insert_launches_per_step"]
    mla = {n: c for n, c in att.items() if "mla_decode" in n}
    kernels = profile["device_kernels_per_step"]
    log(f"[profile]   MLA decode kernels per step: {mla}; insert kernels "
        f"per step: {ins}; {kernels:.1f} device kernels per step "
        f"({kernels / n_layers:.2f} a layer)")
    if (len(mla) != 1 or any("combine" in n for n in att)
            or not 0 < sum(mla.values()) <= n_layers + 1e-9):
        raise AssertionError(f"decode profile: one MLA kernel, {n_layers} "
                             f"launches a step, expected; got {att}")
    if (len(ins) != 1 or not all("mla_rope_insert_kernel" in n for n in ins)
            or not 0 < sum(ins.values()) <= n_layers + 1e-9):
        raise AssertionError(f"decode profile: one fused MLA insert kernel, "
                             f"{n_layers} launches a step, expected; got "
                             f"{ins}")


def check_launches(what: str, launches: dict, expect: dict) -> None:
    for k, v in expect.items():
        if launches[k] != v:
            raise AssertionError(f"{what}: {k}: {launches[k]} launches, "
                                 f"expected {v}")
    check_tiles(what, launches)


def moe_expected(cfg, chunks: int, decode: int, paged: bool) -> dict:
    """Exact launches of a MoE model's forwards: wqkv, (w_q_b,) wo and
    lm_head through dequant_matmul, and a DeepSeek model's dense-prefix MLP
    and shared experts; gate|up and down of the routing layers through
    dequant_matmul_moe; and the decode pair of the cache (paged, contiguous
    or MLA latent) per decode forward and layer, a GQA insert's also under
    [fused]."""
    fwd, ln, k0 = chunks + decode, cfg.n_layers, cfg.first_k_dense
    pairs = {"paged": ("paged_cache_insert_int8", "paged_flash_decode_int8",
                       "paged_cache_insert_int8[fused]"),
             "contiguous": ("cache_insert_int8", "flash_decode_int8",
                            "cache_insert_int8[fused]"),
             "mla": ("mla_cache_insert_int8", "mla_flash_decode_int8",
                     "mla_cache_insert_int8[fused]")}
    kind = "mla" if cfg.is_mla else "paged" if paged else "contiguous"
    dense = ((2 + bool(cfg.q_lora_rank)) * ln + 2 * k0
             + 2 * moe_layers(cfg) * bool(cfg.n_shared_experts) + 1)
    return {"dequant_matmul": dense * fwd,
            "dequant_matmul_moe": 2 * moe_layers(cfg) * fwd,
            **{k: ln * decode * (kind == name) for name, pair in pairs.items()
               for k in pair}}


def served_rows(eng, prompts, prefix_len: int):
    """Row keys (``held_routing``) of an engine's forwards: the decode
    forward's rows are its slots, each at the position of the token it
    feeds; a prefill chunk's rows are the admitting request's positions.
    A request is named by its prompt's index; positions in the shared
    prefix by "prefix"."""
    def key(req, pos):
        return (("prefix", pos) if pos < prefix_len
                else (prompts.index(req.prompt), pos))

    def rows(x):
        if x.shape[0] == eng.max_slots and x.shape[1] == 1:
            return [None if r is None
                    else key(r, len(r.prompt) + len(r.output) - 1)
                    for r in eng.slots]
        req, _, off = eng._prefilling
        return [key(req, off + j) for j in range(x.shape[1])]
    return rows


def park_at_lengths(eng, lens) -> None:
    """Give every slot of a paged engine fresh pages for ``lens`` tokens
    (ids past the allocator's, for a throwaway measurement after the drain)
    and those lengths."""
    c = eng.cache
    page = c.page_size
    ids = iter(range(1, eng.n_pages))
    tbl = np.zeros(tuple(c.page_tbl.shape), np.int32)
    for b, n in enumerate(lens):
        tbl[b, :-(-n // page)] = [next(ids) for _ in range(-(-n // page))]
    c.page_tbl.copy_(torch.from_numpy(tbl))
    c.lengths.copy_(torch.tensor(lens, dtype=torch.int32))


def phase_moe_serving(detail: dict, params, cfg) -> dict:
    """Full-width Mixtral-8x7B over HTTP from the paged, prefix-cached
    engine: 8 greedy requests from 4 client threads, each a shared 512-token
    prefix plus a 16-128-token suffix, 32 new tokens. At B=8 about 90% of
    the experts are hot, so every forward takes all-experts slots. Exact
    launch counts, 7 prefix hits, every page free or cached after the
    drain, a profile of 3 B=8 decode forwards, and every answer checked by
    teacher forcing through the contiguous cache."""
    from quant_tpu_torch.engine import Engine

    n_req, n_new, prefix_len = 8, 32, 512
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, prefix_len)]
    suffix_lens = rng.integers(16, 129, n_req)
    prompts = [prefix + [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in suffix_lens]
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, max_slots=8, max_seq=2048, eos_id=-1,
                 device="cuda", paged=True, page_size=128, prefix_cache=True)
    # the experts every served token kept are recorded for the teacher
    # forcing (two more small device ops per layer and forward, and host
    # work per forward): the served times include the recorder, the
    # profile's bare forwards do not
    with moe_dispatch() as slots, held_routing(
            cfg.n_layers, served_rows(eng, prompts, prefix_len)) as routing:
        traffic = http_traffic(eng, prompts, n_new, 4, "mixtral-8x7b")
    stats, launches, steps = (traffic["stats"], traffic["launches"],
                              traffic["steps"])
    expect = moe_expected(cfg, stats["prefill_chunks"],
                          stats["decode_forwards"], paged=True)
    check_launches("moe serving", launches, expect)
    if slots["hot"] or slots["all"] != expect["dequant_matmul_moe"]:
        raise AssertionError(f"moe serving: {slots} MoE calls; every one "
                             "should take all experts at B=8")
    if stats["prefix_hit_tokens"] != (n_req - 1) * prefix_len:
        raise AssertionError(f"prefix_hit_tokens {stats['prefix_hit_tokens']}"
                             f", expected {(n_req - 1) * prefix_len}")
    if stats["free_pages"] + stats["cached_blocks"] != stats["total_pages"]:
        raise AssertionError(f"after the drain, {stats['free_pages']} free + "
                             f"{stats['cached_blocks']} cached pages of "
                             f"{stats['total_pages']}")
    pure = [st for st in steps if st["decode"] and not st["chunks"]]
    decode_ms = 1e3 * sum(st["s"] for st in pure) / max(1, len(pure))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttfts = sorted(1e3 * r.ttft for r in traffic["admitted"])
    total = traffic["total_s"]
    log(f"[moe-serving] {n_req} HTTP requests (4 clients, half streamed), "
        f"shared {prefix_len}-token prefix + {suffix_lens.min()}-"
        f"{suffix_lens.max()} suffix, {n_new} new tokens each: "
        f"{stats['prefill_chunks']} prefill chunks, "
        f"{stats['decode_forwards']} decode steps; launches {launches} "
        f"(expected {expect}); MoE calls {slots}")
    log(f"[moe-serving] prefix_hit_tokens {stats['prefix_hit_tokens']}, "
        f"after the drain {stats['free_pages']} free + "
        f"{stats['cached_blocks']} cached = {stats['total_pages']} pages; "
        f"at most {traffic['peak_pages_in_use']} pages in use")
    log(f"[moe-serving] decode {decode_ms:.2f} ms/step (B=8, routing "
        f"recorded), "
        f"{n_req * n_new / total:.1f} tok/s overall, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.0f} ms max {ttfts[-1]:.0f} ms, "
        f"max_memory_allocated {peak_gib:.2f} GiB")
    park_at_lengths(eng, [len(p) + n_new for p in prompts])
    profile = profile_decode(eng, label="Mixtral-8x7B paged decode")
    del eng
    torch.cuda.empty_cache()
    outs = [traffic["results"][i]["output_ids"] for i in range(n_req)]
    tf = teacher_forced(params, cfg, prompts, prefix_len, outs,
                        tag="moe-serving", kept=routing["kept"])
    out = {"requests": n_req, "new_tokens": n_new, "prefix_len": prefix_len,
           "suffix_lens": suffix_lens.tolist(),
           "prefill_chunks": stats["prefill_chunks"],
           "decode_forwards": stats["decode_forwards"],
           "launches": launches, "expected_launches": expect,
           "moe_calls": slots, "total_s": total,
           "tokens_per_s": n_req * n_new / total,
           "decode_ms_per_step": decode_ms,
           "ttft_ms_p50": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
           "max_memory_allocated_gib": peak_gib,
           "peak_pages_in_use": traffic["peak_pages_in_use"],
           "teacher_forced": tf, "profile": profile, "stats": stats,
           "healthz": traffic["healthz"], "steps": steps}
    detail["moe_serving"] = out
    return out


def phase_moe_single(detail: dict, params, cfg) -> dict:
    """The same model behind ``Engine(max_slots=1)``: one request of 32 new
    tokens. B=1 takes the routed path, so every decode forward launches the
    MoE kernel with a hot list of the 2 routed experts. Profiles 3 B=1
    decode forwards routed and with all experts (``moe_routed="off"``)."""
    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.kernels import _build

    eng = Engine(params, cfg, max_slots=1, max_seq=2048, eos_id=-1,
                 device="cuda")
    rng = np.random.default_rng(1)
    req = Request(req_id=0, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, 64)], max_new_tokens=32)
    torch.cuda.synchronize()
    _build.reset_launches()
    steps = []
    with moe_dispatch() as slots:
        eng.add_request(req)
        while eng.has_work():
            chunks0 = eng.prefill_chunks
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0,
                          eng.prefill_chunks - chunks0))
    launches = dict(_build.launches)
    if len(req.output) != 32:
        raise AssertionError(f"moe single: {len(req.output)} tokens")
    chunks, dec = eng.prefill_chunks, eng.decode_forwards
    expect = moe_expected(cfg, chunks, dec, paged=False)
    check_launches("moe single", launches, expect)
    if slots != {"hot": 2 * cfg.n_layers * dec,
                 "all": 2 * cfg.n_layers * chunks}:
        raise AssertionError(f"moe single: MoE calls {slots}, expected the "
                             f"hot list at each of {dec} decode forwards")
    # every step decodes; the first one also prefills the prompt
    pure = [t for t, chunk in steps if not chunk]
    decode_ms = 1e3 * sum(pure) / max(1, len(pure))
    routed = profile_decode(eng, label="Mixtral-8x7B decode, routed")
    dense = profile_decode(eng, label="Mixtral-8x7B decode, all experts",
                           cfg=dataclasses.replace(cfg, moe_routed="off"))
    moe_ms = {k: p["port_kernels_ms_per_step"].get(
        "dequant_matmul_moe_kernel", 0.0) for k, p in (("routed", routed),
                                                       ("all", dense))}
    log(f"[moe-single] 1 request, 64-token prompt -> 32 tokens: {chunks} "
        f"prefill chunk, {dec} decode steps, launches {launches}; MoE calls "
        f"{slots}; decode {decode_ms:.2f} ms/step (B=1); MoE kernel device "
        f"time per step: routed {moe_ms['routed']:.3f} ms, all experts "
        f"{moe_ms['all']:.3f} ms")
    out = {"launches": launches, "expected_launches": expect,
           "moe_calls": slots, "decode_forwards": dec,
           "decode_ms_per_step": decode_ms, "ttft_ms": 1e3 * req.ttft,
           "moe_kernel_ms_per_step": moe_ms, "profile_routed": routed,
           "profile_all_experts": dense}
    detail["moe_single"] = out
    return out


def moe_model_check(detail: dict, tag: str, params, cfg, b: int, t: int,
                    n_decode: int, variants: dict, pairs, faults=None,
                    controls=()) -> None:
    """One prefill of T tokens and ``n_decode`` decode steps at batch B
    under each config variant (name -> field changes), every variant with
    the experts the first one kept (``held_routing``); each pair of
    variants must agree within 5e-2 of max|logit| (the model limit).
    ``faults``: variant name -> a context manager that plants a fault while
    that variant runs; each pair of ``controls`` must differ by more than
    the limit."""
    from quant_tpu_torch.models import llama

    rng = np.random.default_rng(1)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)))] + [
        torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
        for _ in range(n_decode)]
    logits, swapped, kept = {}, {}, None
    at = [0]

    def rows(x):
        n = x.shape[1]
        return [(i, at[0] + j) for i in range(b) for j in range(n)]
    for name, change in variants.items():
        c = dataclasses.replace(cfg, **change)
        cache = llama.init_cache(c, b, t + n_decode, "cuda")
        outs = []
        fault = (faults or {}).get(name, contextlib.nullcontext)
        with held_routing(moe_layers(cfg), rows, kept) as routing, fault():
            at[0] = 0
            for tok in tokens:
                lg, cache = llama.forward(params, tok, cache, c,
                                          device="cuda")
                at[0] += tok.shape[1]
                outs.append(lg[:, -1].float())
        kept, swapped[name] = routing["kept"], routing["swapped"]
        logits[name] = torch.stack(outs)
        if not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"{tag}: non-finite logits ({name})")
        del cache, outs
    log(f"[{tag}] routing held to the first variant's experts; (token, "
        f"layer) decisions that would have kept others: {swapped} of "
        f"{b * (t + n_decode) * moe_layers(cfg)} per variant")
    res = {"swapped_routing_decisions": swapped}
    for (a, r), control in ([(p, False) for p in pairs]
                            + [(p, True) for p in controls]):
        x, y = logits[a], logits[r]
        rel = float((x - y).abs().max() / y.abs().max())
        agree = float((x.argmax(-1) == y.argmax(-1)).float().mean())
        res[f"{a} vs {r}"] = {"rel_err": rel, "argmax_agreement": agree}
        log(f"[{tag}] prefill(T={t}) + {n_decode} decode steps, B={b}: {a} "
            f"vs {r} max|dlogit| = {rel:.3e} of max|logit|, argmax "
            f"agreement {agree:.3f}" + (" (control: must exceed 5e-2)"
                                        if control else ""))
        if control and not rel > 5e-2:
            raise AssertionError(f"{tag}: the control {a} vs {r} differs by "
                                 f"only {rel:.3g}: the check cannot see it")
        if not control and not rel <= 5e-2:
            raise AssertionError(f"{tag}: {a} vs {r} logits differ by "
                                 f"{rel:.3g}")
    detail[f"{tag}_model"] = res


def phase_qwen3(detail: dict, cfg) -> dict:
    """Full-width Qwen3-30B-A3B (48 layers, 128 experts top-8, qk_norm,
    down K padded 768 -> 1024, random weights from seed 0 on the card)
    behind ``Engine(max_slots=8, max_seq=1024)`` in process: 8 greedy
    requests of 64-256 prompt tokens, 16 new tokens each. Decode at B=8
    routes (about 52 of 128 experts hot), so every decode forward launches
    the hot-list kernel; prefill takes all experts. Exact launch counts,
    teacher forcing, a profile of 3 decode forwards, and one prefill plus 2
    decode steps with the kernels against the plain versions."""
    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    unit_gain_router(params, cfg)
    torch.cuda.synchronize()
    log(f"[qwen3-moe] qwen3-30b-a3b params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng = Engine(params, cfg, max_slots=8, max_seq=1024, eos_id=-1,
                 device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 257, 8)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    calls = []
    t0 = time.perf_counter()
    # step(): one decode forward per call, so the recorded rows know their
    # positions
    with moe_dispatch() as slots, held_routing(
            cfg.n_layers, served_rows(eng, prompts, 0)) as routing:
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            c0 = time.perf_counter()
            chunks0, dec0 = eng.prefill_chunks, eng.decode_forwards
            eng.step()
            torch.cuda.synchronize()
            calls.append({"s": time.perf_counter() - c0,
                          "chunks": eng.prefill_chunks - chunks0,
                          "decode": eng.decode_forwards - dec0})
    total = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not all(r.finished and len(r.output) == 16 for r in reqs):
        raise AssertionError("qwen3: not every request finished with 16 "
                             "tokens")
    chunks, dec = eng.prefill_chunks, eng.decode_forwards
    expect = moe_expected(cfg, chunks, dec, paged=False)
    check_launches("qwen3", launches, expect)
    if slots != {"hot": 2 * cfg.n_layers * dec,
                 "all": 2 * cfg.n_layers * chunks}:
        raise AssertionError(f"qwen3: MoE calls {slots}, expected hot lists "
                             f"at each of {dec} decode forwards")
    pure = [c for c in calls if c["decode"] and not c["chunks"]]
    decode_ms = (1e3 * sum(c["s"] for c in pure)
                 / max(1, sum(c["decode"] for c in pure)))
    ttfts = sorted(1e3 * r.ttft for r in reqs)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[qwen3-moe] 8 requests, prompts {lens.tolist()} -> 16 tokens "
        f"each: {chunks} prefill chunks, {dec} decode steps; launches "
        f"{launches} (expected {expect}); MoE calls {slots}")
    log(f"[qwen3-moe] decode {decode_ms:.2f} ms/step (B=8, routing "
        f"recorded), "
        f"{8 * 16 / total:.1f} tok/s overall, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.0f} ms max {ttfts[-1]:.0f} ms, "
        f"max_memory_allocated {peak_gib:.2f} GiB")
    profile = profile_decode(eng, label="Qwen3-30B-A3B decode, routed")
    del eng
    torch.cuda.empty_cache()
    tf = teacher_forced(params, cfg, prompts, 0, [r.output for r in reqs],
                        tag="qwen3-moe", kept=routing["kept"])
    moe_model_check(detail, "qwen3-moe", params, cfg, 8, 32, 2,
                    {"kernels": {}, "plain": {"kernel_mode": "xla"}},
                    [("kernels", "plain")])
    out = {"prompt_lens": lens.tolist(), "prefill_chunks": chunks,
           "decode_forwards": dec, "launches": launches,
           "expected_launches": expect, "moe_calls": slots,
           "total_s": total, "decode_ms_per_step": decode_ms,
           "tokens_per_s": 8 * 16 / total,
           "ttft_ms_p50": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
           "max_memory_allocated_gib": peak_gib, "teacher_forced": tf,
           "profile": profile, "step_calls": calls}
    detail["qwen3_moe"] = out
    return out


def phase_dsv2_serving(detail: dict, params, cfg) -> dict:
    """Full-width DeepSeek-V2-Lite (27 layers: MLA, 64 experts top-6 with 2
    shared experts, one dense-prefix layer) over HTTP from the contiguous
    engine ``Engine(max_slots=8, max_seq=2048)``: 8 greedy requests of
    64-1024 prompt tokens, 64 new tokens each, from 4 client threads (half
    streamed). Decode at B=8 routes (about 35 of 64 experts hot), so every
    decode forward takes the hot-list MoE kernel, and the MLA pair 27 times;
    prefill takes all experts. Exact launch counts, a profile of 3 decode
    forwards at the final lengths, and every answer teacher-forced through
    the plain path with the served experts held."""
    from quant_tpu_torch.engine import Engine

    n_req, n_new = 8, 64
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, n_req)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, max_slots=8, max_seq=2048, eos_id=-1,
                 device="cuda")
    cache_bytes = sum(t.numel() * t.element_size() for t in (
        eng.cache.k_codes, eng.cache.k_scale))
    with moe_dispatch() as slots, held_routing(
            moe_layers(cfg), served_rows(eng, prompts, 0)) as routing:
        traffic = http_traffic(eng, prompts, n_new, 4, "deepseek-v2-lite")
    stats, launches, steps = (traffic["stats"], traffic["launches"],
                              traffic["steps"])
    chunks, dec = stats["prefill_chunks"], stats["decode_forwards"]
    expect = moe_expected(cfg, chunks, dec, paged=False)
    check_launches("dsv2 serving", launches, expect)
    want = {"hot": 2 * moe_layers(cfg) * dec,
            "all": 2 * moe_layers(cfg) * chunks}
    if slots != want:
        raise AssertionError(f"dsv2 serving: MoE calls {slots}, expected "
                             f"{want} (hot lists at every decode forward)")
    pure = [st for st in steps if st["decode"] and not st["chunks"]]
    decode_ms = 1e3 * sum(st["s"] for st in pure) / max(1, len(pure))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ttfts = sorted(1e3 * r.ttft for r in traffic["admitted"])
    total = traffic["total_s"]
    log(f"[dsv2-serving] {n_req} HTTP requests (4 clients, half streamed), "
        f"prompts {lens.tolist()}, {n_new} new tokens each: {chunks} prefill "
        f"chunks, {dec} decode steps; launches {launches} (expected "
        f"{expect}); MoE calls {slots}")
    log(f"[dsv2-serving] decode {decode_ms:.2f} ms/step (B=8, routing "
        f"recorded), {1e3 * 8 / decode_ms:.1f} decode tok/s, "
        f"{n_req * n_new / total:.1f} tok/s overall, TTFT p50 "
        f"{ttfts[len(ttfts) // 2]:.0f} ms max {ttfts[-1]:.0f} ms, "
        f"max_memory_allocated {peak_gib:.2f} GiB (latent cache "
        f"{cache_bytes / 2**20:.0f} MiB)")
    # the decode step alone at the traffic's final lengths
    eng.cache.lengths.copy_(torch.tensor([n + n_new for n in lens],
                                         dtype=torch.int32))
    profile = profile_decode(eng, label="DeepSeek-V2-Lite decode, routed")
    check_mla_profile(profile, cfg.n_layers)
    del eng
    torch.cuda.empty_cache()
    outs = [traffic["results"][i]["output_ids"] for i in range(n_req)]
    tf = teacher_forced(params, dataclasses.replace(cfg, kernel_mode="xla"),
                        prompts, 0, outs, tag="dsv2-serving",
                        kept=routing["kept"])
    mla_fault_check(detail, "dsv2-short", params, cfg)
    out = {"requests": n_req, "new_tokens": n_new,
           "prompt_lens": lens.tolist(), "prefill_chunks": chunks,
           "decode_forwards": dec, "launches": launches,
           "expected_launches": expect, "moe_calls": slots,
           "total_s": total, "tokens_per_s": n_req * n_new / total,
           "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": 1e3 * 8 / decode_ms,
           "ttft_ms_p50": ttfts[len(ttfts) // 2], "ttft_ms_max": ttfts[-1],
           "max_memory_allocated_gib": peak_gib,
           "latent_cache_bytes": cache_bytes, "teacher_forced": tf,
           "profile": profile, "stats": stats,
           "healthz": traffic["healthz"], "steps": steps}
    detail["dsv2_serving"] = out
    return out


def phase_dsv3(detail: dict, cfg) -> dict:
    """DeepSeek-V3 at full width and reduced depth (3 dense-prefix layers
    and 1 MoE layer of 256 experts; low-rank q, sigmoid group-limited
    routing with a selection bias, 128 heads), random weights from seed 0
    on the card, in process behind ``Engine(max_slots=4, max_seq=512)``: 4
    greedy requests of 128 prompt tokens, 8 new tokens each. Decode at B=4
    routes (at most 32 of 256 experts hot). Exact launch counts, then one
    prefill and 2 decode steps with the kernels against the plain versions,
    experts held."""
    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[dsv3] deepseek-v3 at {cfg.n_layers} layers made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    unit_gain_router(params, cfg)
    unit_gain_attention(params, cfg)
    eng = Engine(params, cfg, max_slots=4, max_seq=512, eos_id=-1,
                 device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, prompt=[int(x) for x in rng.integers(
        0, cfg.vocab_size, 128)], max_new_tokens=8) for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with moe_dispatch() as slots:
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not all(r.finished and len(r.output) == 8 for r in reqs):
        raise AssertionError("dsv3: not every request finished with 8 "
                             "tokens")
    chunks, dec = eng.prefill_chunks, eng.decode_forwards
    expect = moe_expected(cfg, chunks, dec, paged=False)
    check_launches("dsv3", launches, expect)
    want = {"hot": 2 * moe_layers(cfg) * dec,
            "all": 2 * moe_layers(cfg) * chunks}
    if slots != want:
        raise AssertionError(f"dsv3: MoE calls {slots}, expected {want}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[dsv3] 4 requests of 128 tokens -> 8 tokens each in {total:.2f}s: "
        f"{chunks} prefill chunks, {dec} decode steps; launches {launches} "
        f"(expected {expect}); MoE calls {slots}; max_memory_allocated "
        f"{peak_gib:.2f} GiB")
    del eng
    torch.cuda.empty_cache()
    # "rerun" repeats "kernels": the kernels' run-to-run spread, the
    # yardstick for kernels against plain
    moe_model_check(detail, "dsv3", params, cfg, 4, 128, 2,
                    {"kernels": {}, "plain": {"kernel_mode": "xla"},
                     "rerun": {}},
                    [("kernels", "plain"), ("rerun", "kernels")])
    mla_fault_check(detail, "dsv3-short", params, cfg)
    out = {"n_layers": cfg.n_layers, "prefill_chunks": chunks,
           "decode_forwards": dec, "launches": launches,
           "expected_launches": expect, "moe_calls": slots, "total_s": total,
           "max_memory_allocated_gib": peak_gib}
    detail["dsv3"] = out
    del params
    torch.cuda.empty_cache()
    return out


def phase_cli(detail: dict, preset: str, extra: tuple = ()) -> None:
    """``python -m quant_tpu_torch generate`` on a checkpoint of ``preset``
    written by the port (``extra``: more flags, e.g. ``--kv-bits 4``):
    three prompts, 8 new tokens each."""
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS[preset], kernel_mode="auto")
    params = llama.init_params(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, params, cfg)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-m", "quant_tpu_torch", "generate", tmp,
             "--prompt-ids", "1,2,3;4,5,6,7;9", "--max-new", "8",
             "--slots", "2", "--max-seq", "64", "--eos-id", "-1",
             "--device", "cuda", *extra],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    what = " ".join((preset,) + tuple(extra))
    if out.returncode != 0:
        raise RuntimeError(f"cli generate ({what}) failed:\n"
                           f"{out.stderr[-4000:]}")
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    if len(lines) != 3 or any(len(x["output"]) != 8 for x in lines):
        raise AssertionError(f"unexpected cli output: {out.stdout!r}")
    log(f"[cli] generate ({what}) printed {len(lines)} JSON lines, e.g. "
        f"{json.dumps(lines[0])}")
    detail[f"cli_{preset}" + "".join(extra).replace("--", "_")] = {
        "lines": lines, "stderr": out.stderr[-2000:]}


def phase_cli_all(detail: dict) -> None:
    """The cli phase: ``generate`` on each tiny preset and on test-tiny
    with ``--kv-bits 4``, ``serve --paged`` on the first two and its refusal
    on the MLA two, ``convert`` of three HF shapes, ``selftest``. Each check
    runs processes of its own and shares nothing with the others, so they
    run at once from a pool of threads (each process pays its own
    interpreter and CUDA start); the first failure is raised after all have
    ended."""
    import concurrent.futures

    jobs = [(phase_cli, (detail, p)) for p in (
        "test-tiny", "test-tiny-moe", "test-tiny-mla", "test-tiny-dsv3")]
    jobs.append((phase_cli, (detail, "test-tiny", ("--kv-bits", "4"))))
    jobs += [(phase_cli_serve, (detail, p))
             for p in ("test-tiny", "test-tiny-moe")]
    jobs += [(phase_cli_paged_mla, (detail, p))
             for p in ("test-tiny-mla", "test-tiny-dsv3")]
    jobs += [(phase_cli_convert, (detail, p))
             for p in ("test-tiny", "test-tiny-moe", "test-tiny-dsv3")]
    jobs.append((phase_selftest, (detail,)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        futures = [pool.submit(fn, *args) for fn, args in jobs]
    for f in futures:
        f.result()


def phase_cli_serve(detail: dict, preset: str) -> None:
    """``python -m quant_tpu_torch serve`` on a checkpoint of ``preset``
    with a paged pool (no prefix cache: admission scatters the prefill cache
    into pages): poll /healthz, two /generate requests, then stop it."""
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS[preset], kernel_mode="auto")
    params = llama.init_params(cfg, seed=0, device="cuda")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, params, cfg)
        log_path = pathlib.Path(tmp) / "serve.log"
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "quant_tpu_torch", "serve", tmp,
                 "--paged", "--page-size", "16", "--port", str(port),
                 "--slots", "2", "--max-seq", "64", "--eos-id", "-1"],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=log_f, stderr=subprocess.STDOUT)
            try:
                t0 = time.perf_counter()
                while True:
                    try:
                        health = http_json(base + "/healthz", timeout=10)
                        break
                    except OSError:
                        if proc.poll() is not None or \
                                time.perf_counter() - t0 > 300:
                            raise RuntimeError(
                                "cli serve did not come up:\n"
                                + log_path.read_text()[-4000:]) from None
                        time.sleep(0.5)
                outs = [http_json(base + "/generate", {
                    "prompt_ids": p, "max_new_tokens": 8})["output_ids"]
                    for p in ([1, 2, 3], [4, 5, 6, 7, 8, 9] * 4)]
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        server_log = log_path.read_text()[-2000:]
    if any(len(o) != 8 for o in outs) or health.get("total_pages") != 2 * 4:
        raise AssertionError(f"unexpected cli serve answers {outs}, "
                             f"healthz {health}")
    log(f"[cli] serve --paged --page-size 16 ({preset}) answered /healthz "
        f"(up in "
        f"{time.perf_counter() - t0:.1f}s) and two /generate requests: "
        f"{outs}")
    detail[f"cli_serve_{preset}"] = {"outputs": outs, "healthz": health,
                           "log": server_log}


def phase_cli_paged_mla(detail: dict, preset: str) -> None:
    """``serve --paged`` on an MLA checkpoint exits with code 2 and the
    "not ported" message naming paged MLA (the paged latent pool is not
    in this slice)."""
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS[preset], kernel_mode="auto")
    params = llama.init_params(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, params, cfg)
        out = subprocess.run(
            [sys.executable, "-m", "quant_tpu_torch", "serve", tmp,
             "--paged", "--port", "0", "--max-seq", "64", "--device",
             "cuda"],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if out.returncode != 2 or "paged MLA" not in out.stderr:
        raise AssertionError(f"serve --paged on {preset}: exit "
                             f"{out.returncode}, stderr {out.stderr[-2000:]}")
    log(f"[cli] serve --paged ({preset}) refused: "
        f"{out.stderr.strip().splitlines()[-1]}")
    detail[f"cli_serve_paged_{preset}"] = out.stderr[-2000:]


# ── Hugging Face checkpoints: convert, load, eval ─────────────────────

_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16",
              torch.float32: "F32"}


def write_safetensors(path, tensors: dict) -> int:
    """A minimal ``.safetensors`` writer (this machine has no safetensors
    package): 8-byte little-endian header length, a JSON header padded with
    spaces to a multiple of 8, then each tensor's little-endian bytes in
    the header's order. Returns the file's size."""
    header, hosts, off = {}, [], 0
    for name, t in tensors.items():
        h = t.detach().contiguous().cpu()
        nb = h.numel() * h.element_size()
        header[name] = {"dtype": _ST_DTYPES[h.dtype], "shape": list(h.shape),
                        "data_offsets": [off, off + nb]}
        hosts.append(h)
        off += nb
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for h in hosts:
            f.write(h.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(hb) + off


def hf_config(cfg) -> dict:
    """The HF ``config.json`` of a Llama, Mixtral or DeepSeek-V3 config."""
    out = {"model_type": "llama", "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.dim, "num_hidden_layers": cfg.n_layers,
           "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "intermediate_size": cfg.intermediate,
           "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
           "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    if cfg.is_mla:
        out.update(
            model_type="deepseek_v3", num_key_value_heads=cfg.n_heads,
            head_dim=cfg.qk_rope_head_dim,
            intermediate_size=cfg.dense_intermediate,
            moe_intermediate_size=cfg.intermediate,
            kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim, n_routed_experts=cfg.n_experts,
            num_experts_per_tok=cfg.experts_per_token,
            n_shared_experts=cfg.n_shared_experts,
            first_k_dense_replace=cfg.first_k_dense,
            routed_scaling_factor=cfg.routed_scaling,
            n_group=cfg.n_expert_groups, topk_group=cfg.topk_groups,
            norm_topk_prob=cfg.norm_topk, rope_interleave=True)
    elif cfg.n_experts:
        out.update(model_type="mixtral", num_local_experts=cfg.n_experts,
                   num_experts_per_tok=cfg.experts_per_token,
                   sliding_window=None)
    return out


def hf_layer(cfg, i: int, gen) -> dict:
    """Layer ``i``'s HF tensors (bf16 ``[out, in]`` linears with std
    1/sqrt(in), unit norms), made on the card."""
    dev, bf = "cuda", torch.bfloat16

    def w(o, k):
        return (torch.randn((o, k), generator=gen, device=dev)
                / math.sqrt(k)).to(bf)

    def ones(n):
        return torch.ones((n,), dtype=bf, device=dev)
    p, d, h = f"model.layers.{i}.", cfg.dim, cfg.n_heads
    t = {p + "input_layernorm.weight": ones(d),
         p + "post_attention_layernorm.weight": ones(d)}
    if cfg.is_mla:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv, ql = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank
        a = p + "self_attn."
        t[a + "q_a_proj.weight"] = w(ql, d)
        t[a + "q_a_layernorm.weight"] = ones(ql)
        t[a + "q_b_proj.weight"] = w(h * (dn + dr), ql)
        t[a + "kv_a_proj_with_mqa.weight"] = w(r + dr, d)
        t[a + "kv_a_layernorm.weight"] = ones(r)
        t[a + "kv_b_proj.weight"] = w(h * (dn + dv), r)
        t[a + "o_proj.weight"] = w(d, h * dv)
    else:
        hd, hkv = cfg.head_dim, cfg.n_kv_heads
        for name, o, k in (("q", h * hd, d), ("k", hkv * hd, d),
                           ("v", hkv * hd, d), ("o", d, h * hd)):
            t[p + f"self_attn.{name}_proj.weight"] = w(o, k)
    it, e = cfg.intermediate, cfg.n_experts
    if e and cfg.is_mla and i >= cfg.first_k_dense:
        m = p + "mlp."
        t[m + "gate.weight"] = w(e, d)
        t[m + "gate.e_score_correction_bias"] = torch.zeros(
            (e,), dtype=torch.float32, device=dev)
        si = cfg.n_shared_experts * it
        t[m + "shared_experts.gate_proj.weight"] = w(si, d)
        t[m + "shared_experts.up_proj.weight"] = w(si, d)
        t[m + "shared_experts.down_proj.weight"] = w(d, si)
        for j in range(e):
            t[m + f"experts.{j}.gate_proj.weight"] = w(it, d)
            t[m + f"experts.{j}.up_proj.weight"] = w(it, d)
            t[m + f"experts.{j}.down_proj.weight"] = w(d, it)
    elif e and not cfg.is_mla:
        m = p + "block_sparse_moe."
        t[m + "gate.weight"] = w(e, d)
        for j in range(e):
            t[m + f"experts.{j}.w1.weight"] = w(it, d)
            t[m + f"experts.{j}.w3.weight"] = w(it, d)
            t[m + f"experts.{j}.w2.weight"] = w(d, it)
    else:
        it = cfg.dense_intermediate or it
        t[p + "mlp.gate_proj.weight"] = w(it, d)
        t[p + "mlp.up_proj.weight"] = w(it, d)
        t[p + "mlp.down_proj.weight"] = w(d, it)
    return t


def write_hf_model(root: pathlib.Path, cfg, seed: int,
                   keep=()) -> tuple[int, dict]:
    """A random HF checkpoint of ``cfg`` (weights made on the card from
    ``seed``, one ``.safetensors`` file for the embeddings and head and one
    per layer) and its ``config.json``. Returns (bytes written, the tensors
    named in ``keep``, still on the card)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    root.mkdir(parents=True)
    v, d = cfg.vocab_size, cfg.dim
    top = {"model.embed_tokens.weight":
           (torch.randn((v, d), generator=gen, device="cuda") * 0.02).to(
               torch.bfloat16),
           "model.norm.weight": torch.ones((d,), dtype=torch.bfloat16,
                                           device="cuda"),
           "lm_head.weight": (torch.randn((v, d), generator=gen,
                                          device="cuda")
                              / math.sqrt(d)).to(torch.bfloat16)}
    kept = {k: x for k, x in top.items() if k in keep}
    total = write_safetensors(root / "model-00000.safetensors", top)
    del top
    for i in range(cfg.n_layers):
        t = hf_layer(cfg, i, gen)
        kept.update({k: x for k, x in t.items() if k in keep})
        total += write_safetensors(root / f"model-{i + 1:05d}.safetensors",
                                   t)
        del t
    (root / "config.json").write_text(json.dumps(hf_config(cfg)))
    return total, kept


def run_cli(args: list, timeout: float = 900) -> tuple[list, float, float]:
    """``python -m quant_tpu_torch <args>`` from the repository root: (its
    stdout's JSON lines, wall seconds, its peak RSS in GiB from
    ``wait4``). Raises on a non-zero exit; kills it at ``timeout``."""
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        p = subprocess.Popen([sys.executable, "-m", "quant_tpu_torch",
                              *args], stdout=fo, stderr=fe, cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=str(ROOT)))
        timer = threading.Timer(timeout, p.kill)
        timer.start()
        try:
            _, status, usage = os.wait4(p.pid, 0)
        finally:
            timer.cancel()
        p.returncode = os.waitstatus_to_exitcode(status)
        fo.seek(0)
        fe.seek(0)
        stdout, stderr = fo.read(), fe.read()
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise RuntimeError(f"cli {args[0]} exited {p.returncode}:\n"
                           f"{stderr[-4000:]}")
    return ([json.loads(x) for x in stdout.strip().splitlines()], wall,
            usage.ru_maxrss / 2 ** 20)


def dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_convert_eval(detail: dict, n_layers: int) -> dict:
    """Llama-3-8B at full width (``n_layers`` deep) from a Hugging Face
    directory to perplexity: random bf16 weights in the HF layout written
    to disk, ``convert`` (int4, g128, C++ coder) in a subprocess, the
    checkpoint loaded onto the card; layer 0's wqkv, w_gate_up and w_down
    and lm_head byte-equal (codes, scales) to ``quantize_tensor_device`` of
    the same source tensors on the card, and their codes unpacked by
    ``unpack_int4_device`` equal to the host codec's unpack of the same
    bytes; the first 512-token window of README.md (byte ids) with the
    kernels against the plain versions; then ``eval`` over 4 windows of
    512 and ``generate`` on two prompts, each in a subprocess. The launch
    counts cover the in-process load, checks and window."""
    from quant_tpu_torch.checkpoint import load_checkpoint
    from quant_tpu_torch.core.qtensor import quantize_tensor_device
    from quant_tpu_torch.eval import tokens_from_file
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels.unpack import check_int4_layout
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS["llama-3-8b"], n_layers=n_layers)
    p0 = "model.layers.0."
    keep = [p0 + f"self_attn.{x}_proj.weight" for x in "qkv"] + [
        p0 + f"mlp.{x}_proj.weight" for x in ("gate", "up", "down")] + [
        "lm_head.weight"]
    out: dict = {"n_layers": n_layers}
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir, ck = pathlib.Path(tmp) / "hf", pathlib.Path(tmp) / "ckpt"
        t0 = time.perf_counter()
        out["hf_bytes"], src = write_hf_model(hf_dir, cfg, 0, keep)
        out["hf_write_s"] = time.perf_counter() - t0
        out["disk_free_gib"] = shutil.disk_usage(tmp).free / 2 ** 30
        log(f"[convert] llama-3-8b ({n_layers} layers, full width) HF "
            f"directory: {out['hf_bytes'] / 1e9:.2f} GB of bf16 "
            f"safetensors written in {out['hf_write_s']:.1f}s "
            f"({out['disk_free_gib']:.1f} GiB left on the temporary disk)")
        lines, out["convert_s"], out["convert_rss_gib"] = run_cli(
            ["convert", str(hf_dir), str(ck), "--bits", "4",
             "--group-size", "128"])
        conv = lines[-1]
        out["coder"] = conv["coder"]
        out["ckpt_bytes"] = dir_bytes(ck)
        log(f"[convert] python -m quant_tpu_torch convert: "
            f"{out['ckpt_bytes'] / 1e9:.3f} GB packed checkpoint in "
            f"{out['convert_s']:.1f}s (in the converter "
            f"{conv['seconds']:.1f}s, device peak "
            f"{conv['device_peak_bytes'] / 2 ** 30:.2f} GiB, host peak RSS "
            f"{out['convert_rss_gib']:.2f} GiB), coder {conv['coder']}")
        if conv["coder"] != "c++":
            raise AssertionError("the converter did not use the C++ coder")
        shutil.rmtree(hf_dir)     # the temporary disk holds one copy

        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        params, lcfg = load_checkpoint(ck, device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        lay = params.layers
        checks = {
            "layers.0.wqkv": (lay.wqkv.layer(0), [
                src[p0 + f"self_attn.{x}_proj.weight"] for x in "qkv"]),
            "layers.0.w_gate_up": (lay.w_gate_up.layer(0), [
                src[p0 + f"mlp.{x}_proj.weight"] for x in ("gate", "up")]),
            "layers.0.w_down": (lay.w_down.layer(0),
                                [src[p0 + "mlp.down_proj.weight"]]),
            "lm_head": (params.lm_head, [src["lm_head.weight"]])}
        for name, (qt, parts) in checks.items():
            w = torch.cat([x.float().T for x in parts], dim=1)
            if w.shape[1] < qt.shape[1]:
                w = torch.nn.functional.pad(w, (0, qt.shape[1] - w.shape[1]))
            direct = quantize_tensor_device(w, 4, 128)
            if not (torch.equal(direct.codes, qt.codes)
                    and torch.equal(direct.scales, qt.scales)):
                raise AssertionError(f"{name}: the converted checkpoint "
                                     "differs from quantize_tensor_device "
                                     "of the same weights")
            check_int4_layout(qt.codes)
            del w, direct
        log(f"[convert] loaded on the card in {out['load_s']:.1f}s; "
            f"{', '.join(checks)} byte-equal to quantize_tensor_device of "
            "the source tensors; their int4 codes unpacked on the card equal "
            "the host codec's")
        del src, checks

        toks = tokens_from_file(str(ROOT / "README.md"))
        win = torch.as_tensor(toks[:513].astype(np.int64), device="cuda")
        res = {}
        with torch.inference_mode():
            for mode in ("auto", "xla"):
                c = dataclasses.replace(lcfg, kernel_mode=mode)
                cache = llama.init_cache(c, 1, 512, "cuda")
                lg, _ = llama.forward(params, win[None, :-1], cache, c,
                                      device="cuda")
                lp = torch.log_softmax(lg[0].float(), dim=-1)
                res[mode] = (lg[0].float(), float(
                    -lp.gather(-1, win[1:, None]).mean()))
                del cache
        launches = dict(_build.launches)
        out["launches"] = launches
        out["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        (a, nll_a), (r, nll_r) = res["auto"], res["xla"]
        rel = float((a - r).abs().max() / r.abs().max())
        out.update(window_rel_err=rel, window_nll_kernels=nll_a,
                   window_nll_plain=nll_r)
        log(f"[convert] first 512-token window: kernels vs plain max|dlogit| "
            f"= {rel:.3e} of max|logit|, mean NLL {nll_a:.5f} vs {nll_r:.5f}"
            f"; launches {launches}; device peak "
            f"{out['device_peak_gib']:.2f} GiB")
        if not (bool(torch.isfinite(a).all()) and rel <= 5e-2
                and abs(nll_a - nll_r) <= 1e-2):
            raise AssertionError(f"converted model: kernels vs plain logits "
                                 f"{rel:.3g}, NLL {nll_a} vs {nll_r}")
        check_launches("convert-eval", launches, {
            "unpack_int4_device": 4, "dequant_matmul": 4 * n_layers + 1,
            "flash_decode_int8": 0, "cache_insert_int8": 0})
        del params, res, a, r
        torch.cuda.empty_cache()

        (ev,), wall, rss = run_cli(["eval", str(ck), "--text",
                                    str(ROOT / "README.md"), "--window",
                                    "512", "--limit-windows", "4"])
        out.update(eval=ev, eval_wall_s=wall, eval_rss_gib=rss)
        if ev["tokens"] != 4 * 512 or not math.isfinite(ev["nll"]):
            raise AssertionError(f"unexpected eval result {ev}")
        log(f"[convert] python -m quant_tpu_torch eval --window 512 "
            f"--limit-windows 4: nll {ev['nll']:.5f} ppl {ev['ppl']:.1f} "
            f"over {ev['tokens']} tokens; load {ev['load_s']:.1f}s, eval "
            f"{ev['eval_s']:.2f}s ({ev['tokens_per_s']:.0f} tokens/s); "
            f"{wall:.1f}s in all, host peak RSS {rss:.2f} GiB")
        gen_lines, wall, rss = run_cli(
            ["generate", str(ck), "--prompt-ids",
             ",".join(str(x) for x in toks[:64]) + ";"
             + ",".join(str(x) for x in toks[64:80]),
             "--max-new", "16", "--slots", "2", "--max-seq", "128",
             "--eos-id", "-1"])
        if len(gen_lines) != 2 or any(len(x["output"]) != 16
                                      for x in gen_lines):
            raise AssertionError(f"unexpected generate output {gen_lines}")
        out.update(generate=[x["output"] for x in gen_lines],
                   generate_wall_s=wall, generate_rss_gib=rss)
        log(f"[convert] python -m quant_tpu_torch generate: 2 prompts (64 "
            f"and 16 tokens), 16 new tokens each in {wall:.1f}s (host peak "
            f"RSS {rss:.2f} GiB): {out['generate']}")
    detail["convert_eval"] = out
    return out


def phase_cli_convert(detail: dict, preset: str) -> None:
    """``convert`` of a tiny random HF directory of ``preset``'s shapes
    (the converter's dense, Mixtral and DeepSeek-V3 branches), then the
    checkpoint loaded on the card and one forward."""
    from quant_tpu_torch.checkpoint import load_checkpoint
    from quant_tpu_torch.models import PRESETS, llama

    cfg = PRESETS[preset]
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir, ck = pathlib.Path(tmp) / "hf", pathlib.Path(tmp) / "ckpt"
        write_hf_model(hf_dir, cfg, 0)
        (conv,), wall, _ = run_cli(["convert", str(hf_dir), str(ck),
                                    "--bits", "4", "--group-size",
                                    str(cfg.group_size)])
        params, lcfg = load_checkpoint(ck, device="cuda")
    for f in ("n_layers", "n_experts", "first_k_dense", "kv_lora_rank",
              "q_lora_rank", "n_shared_experts"):
        if getattr(lcfg, f) != getattr(cfg, f):
            raise AssertionError(f"convert {preset}: {f} {getattr(lcfg, f)} "
                                 f"!= {getattr(cfg, f)}")
    cache = llama.init_cache(lcfg, 1, 16, "cuda")
    lg, _ = llama.forward(params, [[1, 2, 3]], cache, lcfg, device="cuda")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"convert {preset}: non-finite logits")
    log(f"[cli] convert ({preset} shapes, HF {hf_config(cfg)['model_type']})"
        f" in {wall:.1f}s, coder {conv['coder']}; loaded, one forward")
    detail[f"cli_convert_{preset}"] = {"wall_s": wall, "coder": conv["coder"]}


def phase_selftest(detail: dict) -> None:
    lines, wall, _ = run_cli(["selftest"], timeout=300)
    if not (lines[0].get("codes_bit_exact") and lines[-1].get("ok")):
        raise AssertionError(f"selftest: {lines}")
    log(f"[cli] selftest in {wall:.1f}s: {json.dumps(lines)}")
    detail["selftest"] = lines


# ── the dense families past Llama (windows, softcaps, kv16) ─────────────

# the windowed decode rows' context: 8 slots spread from 1 to 8192 tokens
# (8 x 8192-token caches), on both sides of the 4096-token window
WINDOW_LENGTHS = [1, 517, 2048, 3000, 4095, 4097, 6000, 8192]
# (label, layers, Hkv, rep, Dh, window, softcap, scale) of the windowed
# decode rows: Gemma-2-9B's local and global layers (query_pre_attn_scalar
# 256: scale 1/16), Mistral-7B's sliding window
WINDOW_ROWS = [("gemma-2-9b local", 42, 8, 2, 256, 4096, 50.0, 1 / 16),
               ("gemma-2-9b global", 42, 8, 2, 256, 0, 50.0, 1 / 16),
               ("mistral-7b", 32, 8, 4, 128, 4096, 0.0, None)]


def window_rows(gen, specs=WINDOW_ROWS, kv4: bool = False
                ) -> tuple[list, dict]:
    """Both GQA decode kernels with a sliding window and a logit softcap at
    Gemma-2-9B's decode shape (B=8, Hkv=8, rep=2, Dh=256, 42 layers of
    S=8192, the lengths above; a local layer: window 4096, softcap 50,
    scale 1/16; a global one: softcap 50) and Mistral-7B's (Dh=128, rep=4,
    32 layers, window 4096), contiguous and paged at page 128, f32 and bf16
    q: each through :func:`decode_row` (one launch on its path, rerun
    bit-equal, 1e-4 / 1e-2 of max|ref| against the plain version, device
    time L2-cold), its bound counting the min(window, length) keys each
    slot reads (and, paged, the table entries of their pages). ``specs``
    names other rows of this form; ``kv4`` runs them over a random int4
    head-pair cache. Returns the rows and the bf16 rows by (kernel, label)
    for the kernels line."""
    from quant_tpu_torch.kernels.attention import (
        flash_decode_int8, flash_decode_int8_reference)
    from quant_tpu_torch.kernels.paged_attention import (
        paged_attention_reference, paged_flash_decode_int8)

    rows, bf16 = [], {}
    lengths = torch.tensor(WINDOW_LENGTHS, dtype=torch.int32, device="cuda")
    B, S, page = len(WINDOW_LENGTHS), 8192, 128
    shapes = {}
    for row in specs:
        shapes.setdefault(row[1:5], []).append(row)
    for (L, H, rep, D), group in shapes.items():
        cache = (rand_cache4 if kv4 else rand_cache)(gen, L, B, H, S, D)
        pool, tbl, _ = page_pool(cache, lengths, page)
        for label, _, _, _, _, w, cap, scale in group:
            n_tok = sum(min(n, w) if w else n for n in WINDOW_LENGTHS)
            n_ids = sum((n - 1) // page - max(0, n - w if w else 0) // page
                        + 1 for n in WINDOW_LENGTHS if n)
            sdpa = sdpa_time(cache, lengths, rep, w)
            opts = dict(softcap=cap, scale=scale)
            what = (f"{label}: B=8 Hkv={H} rep={rep} D={D} S=8192 window {w} "
                    f"softcap {cap:g} ctx={n_tok}")
            for name, kernel, plain, extra in (
                    ("flash_decode_int8",
                     lambda q, i: flash_decode_int8(q, *cache, lengths, i, w,
                                                    **opts),
                     lambda q, i: flash_decode_int8_reference(
                         q, *cache, lengths, i, w, **opts), 0),
                    ("paged_flash_decode_int8",
                     lambda q, i: paged_flash_decode_int8(
                         q, *pool, tbl, lengths, i, w, **opts),
                     lambda q, i: paged_attention_reference(
                         q, *pool, tbl, lengths, i, w, **opts), 4 * n_ids)):
                att = {}
                for qdt, tol in ((torch.float32, 1e-4),
                                 (torch.bfloat16, 1e-2)):
                    q = torch.randn((B, H * rep, D), generator=gen,
                                    device="cuda").to(qdt)
                    att[str(qdt)] = decode_row(
                        name, kernel, plain, q, tol, L - 1, L, n_tok, H, sdpa,
                        (f"page={page} " if extra else "") + what,
                        extra_bytes=extra, kv4=kv4)
                    att[str(qdt)].pop("out")
                rows.append({"kernel": name, "rows": label, "window": w,
                             "softcap": cap, "keys": n_tok, "kv4": kv4,
                             "per_dtype": att})
                bf16[name, label] = dict(att["torch.bfloat16"], keys=n_tok)
        del cache, pool
        torch.cuda.empty_cache()
    for name in ("flash_decode_int8", "paged_flash_decode_int8"):
        if (name, "gemma-2-9b global") not in bf16:
            continue
        loc, glo = (bf16[name, f"gemma-2-9b {k}"] for k in ("local", "global"))
        log(f"[kernels] {name} bf16, Gemma-2-9B local layer / global layer: "
            f"time {loc['ms'] / glo['ms']:.3f}, keys read "
            f"{loc['keys'] / glo['keys']:.3f}")
    return rows, bf16


def slot_cache(cache, b: int):
    """Slot ``b`` of a cache as a batch-1 cache over the same tensors (a
    view: a prefill through it writes the slot in place), at length 0."""
    from quant_tpu_torch.models import llama

    zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
    if isinstance(cache, llama.PagedKVCache):
        return dataclasses.replace(cache, page_tbl=cache.page_tbl[b:b + 1],
                                   lengths=zero)
    return llama.KVCache(*(t[:, b:b + 1] for t in (
        cache.k_codes, cache.k_scale, cache.v_codes, cache.v_scale)),
        lengths=zero)


def family_cache(cfg, b: int, max_seq: int, paged: bool, page: int = 128):
    """A contiguous cache, or a pool with each slot's pages in shuffled
    order (seed 0)."""
    from quant_tpu_torch.models import llama

    if not paged:
        return llama.init_cache(cfg, b, max_seq, "cuda")
    n = max_seq // page
    cache = llama.init_paged_cache(cfg, b, max_seq, 1 + b * n, page,
                                   device="cuda")
    perm = np.random.default_rng(0).permutation(np.arange(1, 1 + b * n))
    cache.page_tbl.copy_(torch.from_numpy(perm.reshape(b, n).astype(
        np.int32)))
    return cache


def family_model_check(detail: dict, tag: str, params, cfg, lens: list,
                       n_decode: int = 4, paged: bool = False,
                       variants: dict | None = None,
                       pairs=(("kernels", "plain"),), logged=()) -> dict:
    """Slots prefilled one at a time to ``lens`` tokens (512-token chunks,
    through a batch-1 view of the slot), then ``n_decode`` decode steps of
    all slots, under each variant (name -> (config changes, paged)):
    by default the kernels (``kernel_mode="auto"``) and the plain versions
    ("xla"), and with ``paged`` the kernels over a page pool (page 128,
    shuffled pages) against the contiguous kernels. Each prefill's last
    logits and every decode step's must agree within 5e-2 of max|logit|
    for each pair of variants (the model limit); the ``logged`` pairs are
    read and logged, not held to it. A kernel variant's decode
    launches must be one decode kernel a layer and step, windowed on the
    local layers, softcapped where the config caps, under [kv4] over the
    int4 cache; they are returned."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.models import llama

    if variants is None:
        variants = {"kernels": ({}, False),
                    "plain": ({"kernel_mode": "xla"}, False)}
        if paged:
            variants["kernels-paged"] = ({}, True)
            pairs = tuple(pairs) + (("kernels-paged", "kernels"),)
    rng = np.random.default_rng(1)
    b = len(lens)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
             for _ in range(n_decode)]
    max_seq = -(-(max(lens) + n_decode) // 128) * 128
    logits, launches = {}, {}
    for name, (change, paged) in variants.items():
        c = dataclasses.replace(cfg, **change)
        cache = family_cache(c, b, max_seq, paged)
        outs = []
        for i, p in enumerate(prompts):
            one = slot_cache(cache, i)
            for a in range(0, len(p), 512):
                lg, one = llama.forward(params, [p[a:a + 512]], one, c,
                                        device="cuda")
            outs.append(lg[0, -1].float())
            del lg
        cache = dataclasses.replace(cache, lengths=torch.tensor(
            lens, dtype=torch.int32, device="cuda"))
        _build.reset_launches()
        dec = []
        for tok in steps:
            lg, cache = llama.forward(params, tok, cache, c, device="cuda")
            dec.append(lg[:, -1].float())
        torch.cuda.synchronize()
        launches[name] = dict(_build.launches)
        logits[name] = torch.cat([torch.stack(outs), torch.cat(dec)])
        if not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"{tag}: non-finite logits ({name})")
        del cache, outs, dec
        torch.cuda.empty_cache()
    res = {"lens": lens, "n_decode": n_decode}
    for a, r in tuple(pairs) + tuple(logged):
        x, y = logits[a], logits[r]
        rel = float((x - y).abs().max() / y.abs().max())
        # the rows of the prefills' last positions, then the decode steps'
        pre = float((x[:b] - y[:b]).abs().max() / y.abs().max())
        agree = float((x.argmax(-1) == y.argmax(-1)).float().mean())
        res[f"{a} vs {r}"] = {"rel_err": rel, "prefill_rel_err": pre,
                              "argmax_agreement": agree}
        log(f"[{tag}] slots prefilled to {lens} tokens + {n_decode} decode "
            f"steps: {a} vs {r} max|dlogit| = {rel:.3e} of max|logit| "
            f"(prefill rows {pre:.3e}), argmax agreement {agree:.3f}"
            f"{' (logged)' if (a, r) in logged else ''}")
        if (a, r) not in logged and not rel <= 5e-2:
            raise AssertionError(f"{tag}: {a} vs {r} logits differ by "
                                 f"{rel:.3g}")
    for name in launches:
        if not name.startswith("kernels") or cfg.kv_bits not in (8, 4):
            continue
        k = launches[name]
        res[f"{name} decode_launches"] = {n: v for n, v in k.items() if v}
        att = ("paged_" if variants[name][1] else "") + "flash_decode_int8"
        check_launches(f"{tag} {name}", k, {
            att: cfg.n_layers * n_decode,
            f"{att}[window]": sum(map(bool, llama.layer_windows(cfg)))
            * n_decode,
            f"{att}[softcap]": cfg.n_layers * n_decode * bool(
                cfg.attn_softcap),
            f"{att}[kv4]": cfg.n_layers * n_decode * (cfg.kv_bits == 4)})
        log(f"[{tag}] {name} decode launches: "
            f"{res[f'{name} decode_launches']}")
    detail[f"{tag}_model"] = res
    return res


def teacher_force_each(params, cfg, prompts, outs, tag: str) -> dict:
    """Each served stream fed back through a batch-1 contiguous cache with
    the kernels (its prompt and all but its last token; the last 32
    positions in one chunk): at each served position the gap from the
    teacher-forced maximum logit to the served token's, over max|logit|,
    must be within ``TF_MARGIN``; each answer read in the next request's
    context (the control) must not pass."""
    from quant_tpu_torch.models import llama

    served, wrong, top1 = [], [], 0
    n_new = len(outs[0])
    max_seq = -(-max(len(p) for p in prompts) // 128) * 128 + 128
    for i, out in enumerate(outs):
        toks = prompts[i] + out[:-1]
        head, tail = toks[:-n_new], toks[-n_new:]
        cache = llama.init_cache(cfg, 1, max_seq, "cuda")
        for a in range(0, len(head), 512):
            _, cache = llama.forward(params, [head[a:a + 512]], cache, cfg,
                                     device="cuda")
        lg, _ = llama.forward(params, [tail], cache, cfg, device="cuda")
        lg = lg[0]
        top, scale = lg.max(-1).values, lg.abs().max(-1).values

        def gap(toks):
            t = torch.tensor(toks, device="cuda")[:, None]
            return ((top - lg.gather(-1, t)[:, 0]) / scale).tolist()
        served.append(gap(out))
        wrong.append(gap(outs[(i + 1) % len(outs)]))
        top1 += int((lg.argmax(-1).cpu() == torch.tensor(out)).sum())
        del cache, lg
    flat = [g for gs in wrong for g in gs]
    res = {"limit": TF_MARGIN, "max_gap": max(map(max, served)),
           "top1_share": top1 / (len(outs) * n_new),
           "control_passed": sum(max(gs) <= TF_MARGIN for gs in wrong),
           "control_median_gap": float(np.median(flat))}
    log(f"[{tag}] teacher-forced: {len(outs) * n_new} served tokens, "
        f"{res['top1_share']:.3f} of them the argmax, largest gap "
        f"{res['max_gap']:.3e} of max|logit| (limit {TF_MARGIN}); control: "
        f"{res['control_passed']} of {len(outs)} pass (median gap "
        f"{res['control_median_gap']:.3e})")
    if not res["max_gap"] <= TF_MARGIN:
        raise AssertionError(f"{tag}: a served token stands "
                             f"{res['max_gap']:.3g} of max|logit| below the "
                             "teacher-forced maximum")
    if res["control_passed"]:
        raise AssertionError(f"{tag}: the teacher-forced check passes "
                             "answers read in the wrong context")
    return res


# Gemma-2-9B serving: 8 prompts, two past the 4096-token window, 32 new
# tokens each
GEMMA2_PROMPTS = [4500, 5000, 64, 200, 517, 1024, 300, 777]
GEMMA2_NEW = 32


@contextlib.contextmanager
def plain_decode_attention():
    """Count the model's plain GQA attention calls at T=1 (``llama.attention``
    with one query position) while the block runs: a decode step that took
    the plain path instead of a decode kernel. Yields the count list."""
    from quant_tpu_torch.models import llama

    seen, inner = [], llama.attention

    def counted(q, *a, **kw):
        if q.shape[1] == 1:
            seen.append(1)
        return inner(q, *a, **kw)
    llama.attention = counted
    try:
        yield seen
    finally:
        llama.attention = inner


def phase_engine_serving(detail: dict, params, cfg, paged: bool, tag: str,
                         prompt_lens: list, n_new: int, max_seq: int) -> dict:
    """A dense model behind ``Engine(max_slots=8, max_seq=max_seq)``,
    contiguous or paged (page 128), in process: 8 greedy requests of
    ``prompt_lens`` tokens, ``n_new`` new each; exact launch counts (one
    fused insert and one decode kernel a layer and decode forward, those
    of the windowed layers under [window], all under [softcap] where the
    config caps, all under [kv4] over the int4 cache, every matmul on a
    tensor-core tile and every attention call on the tc path) and no decode
    step on the plain attention path, the decode step's time, a profile of
    3 B=8 decode forwards at the final lengths, and every served token
    teacher-forced (no answer read in another request's context may
    pass)."""
    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.models import llama

    eng = Engine(params, cfg, max_slots=8, max_seq=max_seq, eos_id=-1,
                 device="cuda", paged=paged, page_size=128 if paged else None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.add_request(r)
    calls = []
    with plain_decode_attention() as plain_calls:
        while eng.has_work():
            c0 = time.perf_counter()
            chunks0, dec0 = eng.prefill_chunks, eng.decode_forwards
            eng.step_block(8)
            torch.cuda.synchronize()
            calls.append({"s": time.perf_counter() - c0,
                          "chunks": eng.prefill_chunks - chunks0,
                          "decode": eng.decode_forwards - dec0})
    total = time.perf_counter() - t0
    launches = dict(_build.launches)
    if not all(r.finished and len(r.output) == n_new for r in reqs):
        raise AssertionError(f"{tag}: not every request finished")
    if plain_calls:
        raise AssertionError(f"{tag}: {len(plain_calls)} decode attention "
                             "calls took the plain path")
    pre = "paged_" if paged else ""
    att, ins = f"{pre}flash_decode_int8", f"{pre}cache_insert_int8"
    n_l, dec = cfg.n_layers, eng.decode_forwards
    local = sum(map(bool, llama.layer_windows(cfg)))
    kv4 = cfg.kv_bits == 4
    expect = {"dequant_matmul": (4 * n_l + 1) * (eng.prefill_chunks + dec),
              ins: n_l * dec, f"{ins}[fused]": n_l * dec, att: n_l * dec,
              f"{att}[tc]": n_l * dec, f"{att}[window]": local * dec,
              f"{att}[softcap]": n_l * dec * bool(cfg.attn_softcap),
              f"{att}[kv4]": n_l * dec * kv4, f"{ins}[kv4]": n_l * dec * kv4}
    if not dec:
        raise AssertionError(f"{tag}: no decode forward")
    check_launches(tag, launches, expect)
    pure = [c for c in calls if c["chunks"] == 0 and c["decode"]]
    decode_ms = (1e3 * sum(c["s"] for c in pure)
                 / max(1, sum(c["decode"] for c in pure)))
    ttfts = sorted(r.ttft for r in reqs)
    out = {"prompt_lens": prompt_lens, "prefill_chunks": eng.prefill_chunks,
           "decode_forwards": dec, "launches": launches,
           "expected_launches": expect, "total_s": total,
           "plain_decode_attention_calls": len(plain_calls),
           "decode_ms_per_step": decode_ms,
           "ttft_ms_p50": 1e3 * ttfts[len(ttfts) // 2],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30}
    log(f"[{tag}] 8 requests, prompts {prompt_lens} -> {n_new} "
        f"tokens each in {total:.1f}s; {eng.prefill_chunks} prefill chunks, "
        f"{dec} decode steps, decode {decode_ms:.2f} ms/step (B=8), TTFT "
        f"p50 {out['ttft_ms_p50']:.0f} ms, max_memory_allocated "
        f"{out['max_memory_allocated_gib']:.2f} GiB; launches as expected "
        f"{expect}, no decode on the plain attention path")
    # the profile's step at the traffic's final lengths
    final = [n + n_new for n in prompt_lens]
    if paged:
        park_at_lengths(eng, final)
    else:
        eng.cache.lengths.copy_(torch.tensor(final, dtype=torch.int32))
    out["profile"] = profile_decode(eng, label=tag)
    outs = [r.output for r in reqs]
    del eng
    torch.cuda.empty_cache()
    out["teacher_forced"] = teacher_force_each(params, cfg, prompts, outs,
                                               tag)
    detail[tag] = out
    return out


def phase_gemma2_serving(detail: dict, params, cfg, paged: bool) -> dict:
    """Full-width Gemma-2-9B behind ``Engine(max_slots=8, max_seq=6144)``,
    contiguous or paged (page 128), through :func:`phase_engine_serving`:
    8 greedy requests (two past the window, so the local layers' window
    masks keys at decode), 21 of the 42 layers windowed, all softcapped."""
    return phase_engine_serving(
        detail, params, cfg, paged,
        "gemma2-paged" if paged else "gemma2-serving", GEMMA2_PROMPTS,
        GEMMA2_NEW, 6144)


# Llama-3-8B at kv_bits=4: 8 prompts of 32-1024 tokens, 32 new tokens each
KV4_PROMPTS = [32, 100, 517, 1024, 300, 777, 64, 900]
KV4_NEW = 32


def phase_kv4_llama(detail: dict, params, cfg) -> dict:
    """Full-width Llama-3-8B (the smoke's params, all 32 layers) over the
    int4 head-pair cache (``kv_bits=4``): slots prefilled one at a time to
    100-2000 tokens and 4 decode steps, the kv4 kernel pair against its
    plain versions under the same matmul kernels (``attn_kernel="xla"``:
    the plain insert chain and attention) and the paged kernels against the
    contiguous ones, each within 5e-2 of max|logit| (one kv4 decode kernel
    a layer and step); beside them, logged, the kernels against the plain
    versions throughout (``kernel_mode="xla"``), at kv4 and at int8: the
    matmul tiles' bf16 rounding moves k and v across the int4 cache's
    coarse code boundaries, which the 32 layers amplify; then 8 requests
    served by the contiguous and by the paged engine
    (:func:`phase_engine_serving`: exactly 32 kv4 decode and 32 kv4 fused
    insert launches a decode forward, none on the plain path, every token
    teacher-forced), each served step's time, profile and peak device
    memory beside the int8 serving phase's."""
    c4 = dataclasses.replace(cfg, kv_bits=4)
    lens = [100, 700, 1500, 2000]
    family_model_check(
        detail, "llama-3-8b-kv4", params, c4, lens, variants={
            "kernels": ({}, False), "kernels-paged": ({}, True),
            "plain-attention": ({"attn_kernel": "xla"}, False),
            "plain": ({"kernel_mode": "xla"}, False)},
        pairs=(("kernels", "plain-attention"), ("kernels-paged", "kernels")),
        logged=(("kernels", "plain"), ("plain-attention", "plain")))
    family_model_check(
        detail, "llama-3-8b-int8-same-lens", params, cfg, lens, variants={
            "kernels": ({}, False), "plain": ({"kernel_mode": "xla"}, False)},
        pairs=(), logged=(("kernels", "plain"),))
    res = {}
    for paged in (False, True):
        tag = "llama-kv4-paged" if paged else "llama-kv4-serving"
        res["paged" if paged else "contiguous"] = phase_engine_serving(
            detail, params, c4, paged, tag, KV4_PROMPTS, KV4_NEW, 2048)
    int8 = detail["serving"]["max_memory_allocated_gib"]
    log(f"[llama-kv4] max_memory_allocated: kv4 contiguous "
        f"{res['contiguous']['max_memory_allocated_gib']:.2f} GiB, paged "
        f"{res['paged']['max_memory_allocated_gib']:.2f} GiB; the int8 "
        f"serving phase {int8:.2f} GiB (same Engine(max_slots=8, "
        f"max_seq=2048) cache)")
    return res


def phase_gemma2(detail: dict) -> dict:
    """Full-width Gemma-2-9B (all 42 layers, random INT4 g128 weights made
    on the card from seed 0): kernels against plain logits at B=4 over
    contexts on both sides of the 4096-token window, then served by the
    contiguous and by the paged engine."""
    from quant_tpu_torch.models import PRESETS, llama

    cfg = PRESETS["gemma-2-9b"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[gemma-2-9b] params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    family_model_check(detail, "gemma-2-9b", params, cfg,
                       [1500, 3900, 4300, 5200])
    res = {"contiguous": phase_gemma2_serving(detail, params, cfg, False),
           "paged": phase_gemma2_serving(detail, params, cfg, True)}
    del params
    torch.cuda.empty_cache()
    return res


# the other dense presets: (preset, layers or None for all, slot lengths,
# a paged kernel variant too); each crosses its window where it has one
FAMILY_CHECKS = [("qwen2-7b", 4, [200, 900], False),
                 ("mistral-7b", 4, [300, 4300], True),
                 ("gemma-7b", 4, [200, 900], False),
                 ("gemma-3-1b", None, [64, 300, 700, 1300], False)]


def phase_families(detail: dict) -> dict:
    """Qwen2-7B, Mistral-7B and Gemma-7B at full width and 4 layers, and
    Gemma-3-1B whole (local and global layers): kernels against plain
    logits each; then Llama-3-8B at 4 layers with the unquantized cache
    (``kv_bits=16``, decoded on the plain path), contiguous against paged.
    Returns each check's result (its kernel variants' decode launches)."""
    from quant_tpu_torch.models import PRESETS, llama

    out = {}
    for preset, layers, lens, paged in FAMILY_CHECKS:
        cfg = PRESETS[preset]
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = llama.init_params(cfg, seed=0, device="cuda")
        out[preset] = family_model_check(detail, preset, params, cfg, lens,
                                         paged=paged)
        del params
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(PRESETS["llama-3-8b"], n_layers=4, kv_bits=16)
    params = llama.init_params(cfg, seed=0, device="cuda")
    family_model_check(detail, "llama-3-8b-kv16", params, cfg,
                       [100, 700, 1500], variants={
                           "contiguous": ({}, False), "paged": ({}, True)},
                       pairs=(("paged", "contiguous"),))
    del params
    torch.cuda.empty_cache()
    return out


def phase_mla_kv16(detail: dict) -> dict:
    """DeepSeek-V2-Lite at full width and 2 layers (its dense-prefix layer
    and one MoE layer; unit-gain router and attention) with the unquantized
    latent cache (``kv_bits=16``, the plain MLA path, as the JAX package
    runs it): a 16-token prefill and one T=1 step at B=2. The logits must be
    finite and of the vocabulary's width, no MLA kernel may launch, the
    cache must hold the latent rows in bf16 with unit scales; the step's
    logits beside the int8 cache's with the kernels (logged)."""
    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS["deepseek-v2-lite"], n_layers=2,
                              kv_bits=16)
    params = llama.init_params(cfg, seed=0, device="cuda")
    unit_gain_router(params, cfg)
    unit_gain_attention(params, cfg)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    out = {}
    for bits in (16, 8):
        c = dataclasses.replace(cfg, kv_bits=bits)
        cache = llama.init_cache(c, 2, 128, "cuda")
        _, cache = llama.forward(params, prompt, cache, c, device="cuda")
        _build.reset_launches()
        lg, cache = llama.forward(params, step, cache, c, device="cuda")
        torch.cuda.synchronize()
        out[bits] = (lg.float(), dict(_build.launches), cache)
    lg, launches, cache = out[16]
    if tuple(lg.shape) != (2, 1, cfg.vocab_size) or not bool(
            torch.isfinite(lg).all()):
        raise AssertionError(f"mla kv16: logits {tuple(lg.shape)}, finite "
                             f"{bool(torch.isfinite(lg).all())}")
    if launches["mla_flash_decode_int8"] or launches["mla_cache_insert_int8"]:
        raise AssertionError(f"mla kv16: an MLA kernel launched: {launches}")
    if (cache.k_codes.dtype != BF16
            or not bool((cache.k_scale[:, :, :, :17] == 1).all())):
        raise AssertionError("mla kv16: the latent cache is not the "
                             "unquantized rows")
    rel = float((lg - out[8][0]).abs().max() / out[8][0].abs().max())
    res = {"logits_shape": list(lg.shape), "kv16_vs_int8_kernels_rel": rel,
           "mla_launches_kv16": launches["mla_flash_decode_int8"],
           "mla_launches_int8": out[8][1]["mla_flash_decode_int8"]}
    log(f"[mla-kv16] deepseek-v2-lite 2 layers, kv_bits=16: one T=1 step at "
        f"B=2 on the plain MLA path, logits finite {list(lg.shape)}, no MLA "
        f"kernel launched (int8: {res['mla_launches_int8']}); max|dlogit| "
        f"against the int8 cache with the kernels {rel:.3e} of max|logit|")
    detail["mla_kv16"] = res
    del params, out, cache
    torch.cuda.empty_cache()
    return res


def windowed_entries(rows: dict, gemma2: dict, families: dict) -> list:
    """The kernels line's entries of the windowed and softcapped decode
    rows (bf16 q), each with its launches from its own path's run: the
    Gemma-2-9B rows from the contiguous and paged serving runs (local
    layers: the windowed launches; global: the others), the Mistral-7B rows
    from its model check's kernel variants."""
    out = []
    for (name, label), s in rows.items():
        w = next(r[5] for r in WINDOW_ROWS if r[0] == label)
        cap = next(r[6] for r in WINDOW_ROWS if r[0] == label)
        if label.startswith("gemma-2-9b"):
            run = gemma2["paged" if name.startswith("paged") else
                         "contiguous"]["launches"]
            n = (run[f"{name}[window]"] if w
                 else run[name] - run[f"{name}[window]"])
        else:
            variant = ("kernels-paged" if name.startswith("paged")
                       else "kernels")
            n = families["mistral-7b"][f"{variant} decode_launches"][
                f"{name}[window]"]
        out.append({
            "name": f"{name} [{label}: window {w}, softcap {cap:g}]",
            "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "unit": f"one call, bf16 q, {label}: B=8, lengths "
                    f"{WINDOW_LENGTHS}, S=8192; device time, each call on the "
                    f"next layer (L2-cold)"})
    return out


def write_detail(path, detail: dict) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(detail, indent=1, default=str))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--detail", type=pathlib.Path,
                    help="write the per-shape details to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import quant_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the quant_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail: dict = {}
    try:
        return run_all(args, detail)
    finally:
        write_detail(args.detail, detail)


def run_all(args, detail: dict) -> int:
    from quant_tpu_torch.models import PRESETS, llama

    t_start = time.perf_counter()
    laps, t_lap = detail.setdefault("phase_s", {}), [t_start]

    def lap(name: str) -> None:
        """Log and keep the wall time since the last lap."""
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now
        log(f"[time] {name} {laps[name]:.1f}s")
    dev = phase_device()
    detail["device"] = dev
    phase_build(detail)
    lap("build")
    summary = phase_kernels(detail)
    lap("kernels")
    summary["dequant_matmul_moe"] = moe_kernels(
        torch.Generator(device="cuda").manual_seed(0), detail)
    lap("moe kernels")
    summary.update(mla_kernels(
        torch.Generator(device="cuda").manual_seed(0), detail))
    lap("mla kernels")
    summary["unpack_int4_device"] = unpack_kernels(
        torch.Generator(device="cuda").manual_seed(0), detail)
    lap("unpack kernels")

    cfg = PRESETS["llama-3-8b"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serving] llama-3-8b params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    serving = phase_serving(detail, params, cfg)
    paged = phase_paged_serving(detail, params, cfg)
    phase_model(detail, params, cfg)
    lap("llama")
    kv4 = phase_kv4_llama(detail, params, cfg)
    del params
    torch.cuda.empty_cache()
    lap("llama-kv4")
    convert = phase_convert_eval(detail, CONVERT_LAYERS)
    lap("convert-eval")

    cfg = PRESETS["mixtral-8x7b"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    unit_gain_router(params, cfg)
    torch.cuda.synchronize()
    log(f"[moe-serving] mixtral-8x7b params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    moe = phase_moe_serving(detail, params, cfg)
    phase_moe_single(detail, params, cfg)
    moe_model_check(detail, "moe-model", params, cfg, 4, 128, 4,
                    {"kernels": {}, "plain": {"kernel_mode": "xla"},
                     "routed-on": {"moe_routed": "on"},
                     "routed-off": {"moe_routed": "off"}},
                    [("kernels", "plain"), ("routed-on", "routed-off"),
                     ("routed-off", "plain")])
    del params
    torch.cuda.empty_cache()
    lap("mixtral")
    phase_qwen3(detail, PRESETS["qwen3-30b-a3b"])
    torch.cuda.empty_cache()
    lap("qwen3")

    cfg = PRESETS["deepseek-v2-lite"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[dsv2-serving] deepseek-v2-lite params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    unit_gain_router(params, cfg)
    unit_gain_attention(params, cfg)
    mla = phase_dsv2_serving(detail, params, cfg)
    del params
    torch.cuda.empty_cache()
    lap("deepseek-v2-lite")
    phase_dsv3(detail, dataclasses.replace(PRESETS["deepseek-v3"],
                                           n_layers=4))
    lap("deepseek-v3")
    gemma2 = phase_gemma2(detail)
    lap("gemma-2-9b")
    families = phase_families(detail)
    phase_mla_kv16(detail)
    lap("families")
    phase_cli_all(detail)
    lap("cli")

    kernels = []
    for name in REPLACES:
        s = summary[name]
        # each kernel's launches from the serving run of its own path
        run = (paged if name.startswith("paged")
               else mla if name.startswith("mla")
               else moe if name == "dequant_matmul_moe"
               else convert if name == "unpack_int4_device" else serving)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": run["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "unit": s["unit"]})
    kernels += windowed_entries(summary["windowed"], gemma2, families)
    for name, s in summary["kv4"].items():
        # the int4 cache's variants, with their launches from the kv4
        # Llama-3-8B serving runs
        run = kv4["paged" if name.startswith("paged") else "contiguous"]
        kernels.append({
            "name": f"{name} [kv4]", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": run["launches"][f"{name}[kv4]"],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "unit": s["unit"]})
    detail["total_s"] = time.perf_counter() - t_start
    log(f"[done] {detail['total_s']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
