"""Contiguous decode time of two checkouts of the port, in turns on one card.

    python -m quant_tpu_torch.tools.decode_ab TREE_A TREE_B
    python -m quant_tpu_torch.tools.decode_ab --preset deepseek-v2-lite A B
    python -m quant_tpu_torch.tools.decode_ab --kv-bits 8,4 . .

Starts one worker process per tree; each imports ``quant_tpu_torch`` from
its own tree and holds a full-width model (random weights, seed 0) behind
``Engine(max_slots=8, max_seq=2048)`` with 8 greedy requests that do not
finish within the run: Llama-3-8B (the default) with 32-1024 prompt tokens
each (``default_rng(0)``, as ``chip_smoke.py``'s serving phase), or all 27
layers of DeepSeek-V2-Lite with 64-1024 prompt tokens each and its routers
and ``w_uk`` scaled to unit gain (as ``chip_smoke.py``'s dsv2-serving phase
draws and scales them, with the smoke's own ``unit_gain_router`` and
``unit_gain_attention``). After all are admitted the workers take turns,
A B B A in each of 5 rounds, so that drift of the shared host falls on both
alike. In its turn a worker times on the host clock 8 ``Engine.step()``
calls (pure decode at B=8; each ends in a device sync) and 8 bare decode
``llama.forward`` calls at the slots' lengths. After the turns each worker
traces 3 bare decode forwards with ``torch.profiler`` (A, then B): device
kernels per step, the runtime's kernel-launch calls per step, device busy
time per step and the host-clock time of the traced steps. One JSON line
per turn and per profile, then a summary line with each tree's medians and
profile. ``--kv-bits`` serves the KV cache at another width: one value for
both workers, or two (tree A's, tree B's), so that one checkout's int8 and
int4 caches run in turns (``--kv-bits 8,4 . .``); each worker is then named
by its tree and width. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

N, ROUNDS, PROFILED = 8, 5, 3
# preset -> the shortest prompt of the 8 requests (the longest is 1024)
PRESETS = {"llama-3-8b": 32, "deepseek-v2-lite": 64}
SMOKE = pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py"


def unit_gain(params, cfg) -> None:
    """A MoE model's routers and a DeepSeek model's ``w_uk`` scaled to unit
    gain in place, by ``chip_smoke.py``'s own functions (loaded from the
    checkout that holds this file, so both trees' weights are scaled
    alike)."""
    if not (cfg.n_experts or cfg.is_mla):
        return
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if cfg.n_experts:
        smoke.unit_gain_router(params, cfg)
    if cfg.is_mla:
        smoke.unit_gain_attention(params, cfg)


def profile(fn, steps: int = PROFILED) -> dict:
    """Device kernels, kernel-launch calls (by CUDA API entry point),
    device busy time (the union of the device events) and host-clock time,
    each per call of ``fn()``, from one ``torch.profiler`` trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    return {"device_kernels_per_step": len(kernels) / steps,
            "launch_calls_per_step": {
                e.key: e.count / steps for e in prof.key_averages()
                if "LaunchKernel" in e.key},
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "traced_ms_per_step": 1e3 * wall / steps}


def worker(tree: str, preset: str, kv_bits: int = 0) -> None:
    # the protocol goes to the original stdout; prints of the package (and
    # of nvcc) go to stderr
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from quant_tpu_torch.engine import Engine, Request
    from quant_tpu_torch.models import PRESETS as MODELS
    from quant_tpu_torch.models import llama

    cfg = MODELS[preset]
    params = llama.init_params(cfg, seed=0, device="cuda")
    if kv_bits:
        cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    unit_gain(params, cfg)
    eng = Engine(params, cfg, max_slots=8, max_seq=2048, eos_id=-1,
                 device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, n)], max_new_tokens=512)
        for i, n in enumerate(rng.integers(PRESETS[preset], 1025, 8))]
    for r in reqs:
        eng.add_request(r)
    while not all(r.output for r in reqs):
        eng.step()
    tokens = torch.zeros((8, 1), dtype=torch.int64, device="cuda")
    for _ in range(2):                                   # warm
        eng.step()
        llama.forward(params, tokens, eng.cache, cfg, device="cuda")
    torch.cuda.synchronize()
    proto.write(json.dumps({"ready": tree}) + "\n")
    for line in sys.stdin:
        if line.strip() == "profile":
            res = profile(lambda: llama.forward(params, tokens, eng.cache, cfg,
                                                device="cuda"))
            proto.write(json.dumps(res) + "\n")
            continue
        if line.strip() != "turn":
            break
        t0 = time.perf_counter()
        for _ in range(N):
            eng.step()
        step_ms = 1e3 * (time.perf_counter() - t0) / N
        lengths = eng.cache.lengths.tolist()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N):
            llama.forward(params, tokens, eng.cache, cfg, device="cuda")
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t0) / N
        proto.write(json.dumps({"step_ms": step_ms, "forward_ms": fwd_ms,
                                "lengths": lengths}) + "\n")
    if any(r.finished for r in reqs):
        raise AssertionError("a request finished within the run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="roots of the two checkouts")
    ap.add_argument("--preset", choices=list(PRESETS),
                    default="llama-3-8b", help="the model (default "
                    "%(default)s)")
    ap.add_argument("--kv-bits", default="",
                    help="KV cache width for both workers (8, 4 or 16), or "
                         "A's and B's (e.g. 8,4); default the preset's")
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bits = [int(b) for b in args.kv_bits.split(",") if b]
    if args.worker:
        worker(args.worker, args.preset, bits[0] if bits else 0)
        return 0
    if len(args.trees) != 2:
        ap.error("give the roots of two checkouts")
    if len(bits) not in (0, 1, 2) or any(b not in (4, 8, 16) for b in bits):
        ap.error("--kv-bits takes one or two of 4, 8, 16")
    bits = (bits * 2)[:2] if bits else []
    # each worker's name: its tree, and its KV width where one is given
    names = [f"{t} kv{b}" for t, b in zip(args.trees, bits)] or list(
        args.trees)
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 2
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         os.path.abspath(t), "--preset", args.preset]
        + (["--kv-bits", str(bits[k])] if bits else []), cwd=t, env=env,
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, bufsize=1)
        for k, t in enumerate(args.trees)]
    try:
        for p in procs:
            ready = p.stdout.readline()
            if not ready:
                raise RuntimeError("a worker ended before it was ready")
        times = {t: [] for t in names}
        for r in range(ROUNDS):
            for k in (0, 1, 1, 0):
                procs[k].stdin.write("turn\n")
                res = json.loads(procs[k].stdout.readline())
                res.update(tree=names[k], round=r)
                times[names[k]].append(res)
                print(json.dumps(res), flush=True)
        profiles = {}
        for k, t in enumerate(names):
            procs[k].stdin.write("profile\n")
            profiles[t] = json.loads(procs[k].stdout.readline())
            print(json.dumps({"tree": t, "profile": profiles[t]}), flush=True)
        for p in procs:
            p.stdin.close()
            if p.wait(timeout=120):
                raise RuntimeError(f"a worker exited with {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    summary = {t: {m: statistics.median(x[m] for x in ts)
                   for m in ("step_ms", "forward_ms")}
               for t, ts in times.items()}
    print(json.dumps({"preset": args.preset, "median": summary,
                      "profile": profiles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
