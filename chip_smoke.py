#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quant_tpu_torch) on one NVIDIA card.

Run from the root of the repository, with one CUDA device:

    python3 chip_smoke.py

Phases; the first failure ends the run with a non-zero exit code:

1. device    name, count, and ``nvidia-smi`` name / power limit.
2. build     nvcc of the three CUDA sources (one process each, in parallel),
             with the register / shared-memory report of ``-Xptxas -v``.
3. kernels   each kernel against its plain PyTorch version at the
             Llama-3-8B shapes and the output dtypes the forward gives
             them, with its device time (``torch.profiler`` kernel events,
             operands rotated so each launch reads them from device
             memory), its bound and the plain version's device time.
4. serving   full-width Llama-3-8B (32 layers, random weights from seed 0,
             made on the card) behind ``Engine(max_slots=8, max_seq=2048)``:
             8 greedy requests of 32-1024 prompt tokens, 64 new tokens each.
             The launch counters must match the forwards run. Then
             ``torch.profiler`` over 3 decode forwards at B=8: device busy
             time, idle share and the kernels that take the most.
5. model     one prefill and 4 decode steps at full width with the kernels
             (kernel_mode "auto") and with the plain versions ("xla").
6. cli       ``python -m quant_tpu_torch generate`` on a test-tiny
             checkpoint written by the port.

Before the last line it prints ``{"kernels": [...]}`` and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
``--detail PATH`` writes the per-shape details as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

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
REPLACES = {
    "dequant_matmul": "quant_tpu/kernels/dequant_matmul.py:312",
    "cache_insert_int8": "quant_tpu/kernels/cache_insert.py:131",
    "flash_decode_int8": "quant_tpu/kernels/attention.py:166",
}
SOURCES = {
    "dequant_matmul": "quant_tpu_torch/csrc/dequant_matmul.cu",
    "cache_insert_int8": "quant_tpu_torch/csrc/cache_insert.cu",
    "flash_decode_int8": "quant_tpu_torch/csrc/flash_decode.cu",
}


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


def phase_kernels(detail: dict) -> dict:
    from quant_tpu_torch.kernels.attention import (
        flash_decode_int8, flash_decode_int8_reference)
    from quant_tpu_torch.kernels.cache_insert import (
        cache_insert_int8, cache_insert_int8_reference)
    from quant_tpu_torch.kernels.dequant_matmul import (
        dequant_matmul, dequant_matmul_reference)
    from quant_tpu_torch.utils.timing import cuda_time, device_time

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, summary = [], {}

    # times: device_time sums the profiler's kernel events (no host enqueue,
    # no launch gaps); cuda_time puts CUDA events around back-to-back calls,
    # where the host's enqueue shows whenever it is slower than the kernel.
    # dequant_matmul, int4 at decode and prefill M with the out_dtype the
    # forward gives each projection; int8 at one shape. The bf16 outputs
    # take the kernel's bf16 stores (split-K through a float32 buffer at
    # decode M, direct at prefill M) and are held against the plain
    # version rounded to bf16 the same way.
    cases = [(4, m, k, n, per, odt) for m in (1, 8, 512)
             for k, n, per, odt in DMM_SHAPES]
    cases += [(8, 8, 4096, 4096, 0, F32), (8, 8, 4096, 6144, 0, BF16)]
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    for bits, m, k, n, per, odt in cases:
        qt = _rand_qt(gen, dev, k, n, bits)
        x = torch.randn((m, k), generator=gen, device=dev).to(BF16)
        ref = dequant_matmul_reference(x, qt, odt).float()
        got = dequant_matmul(x, qt, out_dtype=odt)
        torch.cuda.synchronize()
        if got.dtype != odt:
            raise AssertionError(f"dequant_matmul gave {got.dtype}, not {odt}")
        err = float((got.float() - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= 2e-2:
            raise AssertionError(f"dequant_matmul int{bits} M={m} {k}x{n} "
                                 f"{odt}: error {rel:.3g} of max|ref| > 2e-2")
        max_err = max(max_err, err)
        wbytes = qt.codes.numel() + qt.scales.numel() * 4
        qts = [qt] + rotating(lambda: _rand_qt(gen, dev, k, n, bits),
                              wbytes)[1:]
        nxt = cycle(qts)
        iters = max(8, len(qts))
        def run():
            return dequant_matmul(x, nxt(), out_dtype=odt)
        ms, ev = device_time(run, iters), cuda_time(run, iters)
        plain = device_time(lambda: dequant_matmul_reference(x, nxt(), odt),
                            iters)
        b_ms, b_by = bound_ms(m * k * 2 + wbytes + m * n * got.element_size(),
                              2 * m * k * n)
        del qts, ref, got
        dt_name = str(odt)[6:]
        row = {"kernel": "dequant_matmul", "bits": bits, "M": m, "K": k,
               "N": n, "out_dtype": dt_name, "max_abs_err": err,
               "rel_err": rel, "ms": ms, "event_ms": ev, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by,
               "pct_of_bound": 100 * b_ms / ms}
        rows.append(row)
        log(f"[kernels] dequant_matmul int{bits} M={m:<3d} {k}x{n} -> "
            f"{dt_name}: err {rel:.2e} of max|ref|  {ms:.4f} ms (events "
            f"{ev:.4f})  plain {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        if bits == 4 and m == 8:
            step["ms"] += per * ms
            step["plain_ms"] += per * plain
            step["bound_ms"] += per * b_ms
    summary["dequant_matmul"] = {
        "max_abs_err": max_err, **step, "bound_by": "bytes",
        "library_ms": None,
        "unit": "one decode step at B=8: 32 x (4096x6144 bf16 out + "
                "4096x4096 f32 + 4096x28672 bf16 + 14336x4096 f32) + "
                "4096x131072 f32, int4 g128, bf16 x; device time, weights "
                "L2-cold"}

    # decode attention pair at B=8, Hkv=8, rep=4, Dh=128, S=2048, 32 layers
    L, B, H, S, D, rep = 32, 8, 8, 2048, 128, 4
    lengths = torch.tensor([1, 100, 517, 1024, 1500, 2047, 2048, 777],
                           dtype=torch.int32, device=dev)

    def codes():
        return torch.randint(-127, 128, (L, B, H, S, D), generator=gen,
                             device=dev, dtype=torch.int16).to(torch.int8)

    def scales():
        return torch.rand((L, B, H, S), generator=gen, device=dev) * 0.015 \
            + 0.005
    cache = [codes(), scales(), codes(), scales()]
    new = [torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                         dtype=torch.int16).to(torch.int8),
           torch.rand((B, 1, H), generator=gen, device=dev),
           torch.randint(-127, 128, (B, 1, H, D), generator=gen, device=dev,
                         dtype=torch.int16).to(torch.int8),
           torch.rand((B, 1, H), generator=gen, device=dev)]
    layer = 5
    plain_cache = [t.clone() for t in cache]
    cache_insert_int8(*cache, *new, lengths, layer)
    cache_insert_int8_reference(*plain_cache, *new, lengths, layer)
    torch.cuda.synchronize()
    for a, r in zip(cache, plain_cache):
        if not torch.equal(a, r):
            raise AssertionError("cache_insert_int8 is not byte-equal to "
                                 "its plain version")
    del plain_cache
    # timed launches walk the 32-layer stack, as a decode step does, so no
    # layer's rows are still in the L2 cache from the launch before
    nxt_layer = cycle(range(L))
    def insert():
        return cache_insert_int8(*cache, *new, lengths, nxt_layer())
    ms, ev = device_time(insert, L), cuda_time(insert, L)
    plain = device_time(lambda: cache_insert_int8_reference(
        *cache, *new, lengths, nxt_layer()), L)
    row_bytes = B * H * (2 * D + 2 * 4)
    b_ms, b_by = bound_ms(2 * row_bytes + B * 4, 0)
    summary["cache_insert_int8"] = {
        "max_abs_err": 0.0, "ms": ms, "event_ms": ev, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "unit": "one call: B=8, Hkv=8, Dh=128, S=2048, 32-layer stack; "
                "device time"}
    rows.append({"kernel": "cache_insert_int8", **summary[
        "cache_insert_int8"]})
    log(f"[kernels] cache_insert_int8 B=8 H=8 D=128 S=2048: byte-equal  "
        f"{ms:.4f} ms (events {ev:.4f})  plain {plain:.4f} ms  bound "
        f"{b_ms:.6f} ms ({b_by})")

    ctx = lengths.clamp(max=S).to(torch.int64)
    n_tok = int(ctx.sum())
    att = {}
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn((B, H * rep, D), generator=gen, device=dev).to(qdt)
        ref = flash_decode_int8_reference(q, *cache, lengths, layer)
        got = flash_decode_int8(q, *cache, lengths, layer)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("flash_decode_int8 gave non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        if not rel <= tol:
            raise AssertionError(f"flash_decode_int8 ({qdt}): error "
                                 f"{rel:.3g} of max|ref| > {tol}")
        def attend():
            return flash_decode_int8(q, *cache, lengths, nxt_layer())
        ms, ev = device_time(attend, L), cuda_time(attend, L)
        plain = device_time(lambda: flash_decode_int8_reference(
            q, *cache, lengths, nxt_layer()), L)
        qb = q.element_size()
        nbytes = (2 * B * H * rep * D * qb + n_tok * H * (2 * D + 8) + B * 4)
        b_ms, b_by = bound_ms(nbytes, 4 * n_tok * H * rep * D)
        att[str(qdt)] = {"max_abs_err": err, "rel_err": rel, "ms": ms,
                         "event_ms": ev, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by}
        log(f"[kernels] flash_decode_int8 {str(qdt)[6:]} B=8 Hkv=8 rep=4 "
            f"D=128 S=2048 ctx={n_tok}: err {rel:.2e} of max|ref|  "
            f"{ms:.4f} ms (events {ev:.4f})  plain {plain:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
    summary["flash_decode_int8"] = {
        **att["torch.bfloat16"], "library_ms": None,
        "unit": f"one call, bf16 q: B=8, Hkv=8, rep=4, Dh=128, S=2048, "
                f"lengths {lengths.tolist()}; device time, each call on "
                f"the next layer of the 32-layer stack (L2-cold)"}
    rows.append({"kernel": "flash_decode_int8", "per_dtype": att})
    detail["kernels"] = rows
    del cache, new
    torch.cuda.empty_cache()
    return summary


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
        "flash_decode_int8": cfg.n_layers * eng.decode_forwards,
    }
    for k, v in expect.items():
        if launches[k] != v or v == 0:
            raise AssertionError(f"{k}: {launches[k]} launches, expected {v}")
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


def profile_decode(eng, steps: int = 3) -> dict:
    """Device time of a few B=8 decode forwards over the engine's cache (the
    slots at their final lengths), from ``torch.profiler``: the busy share
    of the host-clock window and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quant_tpu_torch.models import llama

    tokens = torch.zeros((eng.max_slots, 1), dtype=torch.int64,
                         device="cuda")
    cache = eng.cache

    def step():
        nonlocal cache
        _, cache = llama.forward(eng.params, tokens, cache, eng.cfg,
                                 device="cuda")
    step()       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same device time again
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tr = e.time_range
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (tr.end - tr.start) / 1e3 / steps)
            spans.append((tr.start, tr.end))
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):        # union: overlapping spans count once
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    busy = busy_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:12]
    res = {"steps": steps, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy if busy else "not measured",
           "idle_share": 1 - busy / wall_ms if busy else "not measured",
           "top_kernels_ms_per_step": top,
           "top_host_ops_self_cpu_ms_per_step": host}
    log(f"[profile] decode B=8 under torch.profiler: {wall_ms:.2f} ms/step "
        f"on the host clock, device busy "
        f"{busy:.2f} ms/step" + (f" (idle share {res['idle_share']:.2f})"
                                 if busy else " (no device time recorded)"))
    for name, ms in top[:6]:
        log(f"[profile]   device {ms:8.3f} ms/step  {name[:80]}")
    for name, ms in host[:6]:
        log(f"[profile]   host   {ms:8.3f} ms/step  {name[:80]}")
    return res


def phase_model(detail: dict, params, cfg) -> None:
    from quant_tpu_torch.models import llama

    rng = np.random.default_rng(1)
    b, t = 2, 128
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
             for _ in range(4)]
    logits = {}
    for mode in ("auto", "xla"):
        c = dataclasses.replace(cfg, kernel_mode=mode)
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
    log(f"[model] full-width prefill(T=128) + 4 decode steps, B=2: kernels "
        f"vs plain max|dlogit| = {rel:.3e} of max|logit|, argmax agreement "
        f"{agree:.3f}")
    detail["model"] = {"rel_err": rel, "argmax_agreement": agree}
    if not rel <= 5e-2:
        raise AssertionError(f"kernel vs plain logits differ by {rel:.3g}")


def phase_cli(detail: dict) -> None:
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.models import PRESETS, llama

    cfg = dataclasses.replace(PRESETS["test-tiny"], kernel_mode="auto")
    params = llama.init_params(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, params, cfg)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-m", "quant_tpu_torch", "generate", tmp,
             "--prompt-ids", "1,2,3;4,5,6,7;9", "--max-new", "8",
             "--slots", "2", "--max-seq", "64", "--eos-id", "-1",
             "--device", "cuda"],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"cli generate failed:\n{out.stderr[-4000:]}")
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    if len(lines) != 3 or any(len(x["output"]) != 8 for x in lines):
        raise AssertionError(f"unexpected cli output: {out.stdout!r}")
    log(f"[cli] generate printed {len(lines)} JSON lines, e.g. "
        f"{json.dumps(lines[0])}")
    detail["cli"] = {"lines": lines, "stderr": out.stderr[-2000:]}


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
    from quant_tpu_torch.models import PRESETS, llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail: dict = {}
    t_start = time.perf_counter()
    dev = phase_device()
    detail["device"] = dev
    phase_build(detail)
    summary = phase_kernels(detail)

    cfg = PRESETS["llama-3-8b"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serving] llama-3-8b params made on the card in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    serving = phase_serving(detail, params, cfg)
    phase_model(detail, params, cfg)
    del params
    torch.cuda.empty_cache()
    phase_cli(detail)

    kernels = []
    for name in ("dequant_matmul", "cache_insert_int8", "flash_decode_int8"):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serving["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "unit": s["unit"]})
    detail["total_s"] = time.perf_counter() - t_start
    write_detail(args.detail, detail)
    log(f"[done] {detail['total_s']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
