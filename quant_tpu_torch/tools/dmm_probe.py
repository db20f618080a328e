"""Probe of ``dequant_matmul``'s tiles on one card.

    python -m quant_tpu_torch.tools.dmm_probe check   # shapes against plain
    python -m quant_tpu_torch.tools.dmm_probe time    # Llama-3-8B shapes
    python -m quant_tpu_torch.tools.dmm_probe plan    # decode split targets
    python -m quant_tpu_torch.tools.dmm_probe ring    # the copy ring alone

``check`` runs both kernels over M, N, group and K edges, int4 and int8,
bf16 and f32 out, the MoE modes and hot lists, and prints each call's tile
and its error against the plain version and against an f32 reference of
the tensor-core tiles' own arithmetic (bf16 codes and x, f32 sums scaled
per group). ``time`` gives device times (``torch.profiler`` kernel events,
weights rotated L2-cold) at Llama-3-8B's shapes at M = 1, 8 and 512 beside
the CUDA-core tile run on the same bf16 x through its own entry point, the
byte or bf16 bound, and torch.matmul on weights dequantized to bf16 ahead
of time; then Mixtral-8x7B's expert stacks. ``plan`` times the decode tile
at the small shapes under split targets of 0.5 to 6 blocks per SM.
``ring`` builds ``ring_bandwidth.cu`` beside this file with nvcc and runs
it: the decode tile's cp.async pattern with no compute. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import subprocess
import tempfile

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, 700 W (data sheet)
BF16_FLOPS = 989e12
# Llama-3-8B projections: (K, N, launches per decode step, out dtype name)
LLAMA = [(4096, 6144, 32, "bf16"), (4096, 4096, 32, "f32"),
         (4096, 28672, 32, "bf16"), (14336, 4096, 32, "f32"),
         (4096, 131072, 1, "f32")]


def _rand_qt(gen, k, n, bits, g, lead=()):
    import torch

    from quant_tpu_torch.core.qtensor import QTensor

    kp = k // 2 if bits == 4 else k
    c = torch.randint(0, 256, lead + (kp, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    c = (c.to(torch.uint8) if bits == 4
         else (c - 128).clamp(-127, 127).to(torch.int8))
    s = torch.rand(lead + (k // g, n), generator=gen, device="cuda") * 0.02
    return QTensor(codes=c, scales=s + 1e-3, bits=bits, group_size=g,
                   shape=(k, n))


def _tiles() -> dict:
    from quant_tpu_torch.kernels import _build

    return {k: v for k, v in _build.launches.items() if "[" in k and v}


def _err(got, ref) -> float:
    scale = float(ref.float().abs().max()) or 1.0
    return float((got.float() - ref.float()).abs().max()) / scale


def check(gen) -> int:
    import torch

    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels import dequant_matmul as D

    bf = torch.bfloat16
    fails = 0
    shapes = [(512, 768, 128), (192, 64, 64), (2048, 3648, 64),
              (10944, 2048, 64), (4096, 4096, 128), (256, 16, 128)]
    for bits in (4, 8):
        for k, n, g in shapes:
            qt = _rand_qt(gen, k, n, bits, g)
            w32 = qt.dequantize(torch.float32)
            for m in (1, 3, 8, 9, 16, 17, 64, 130, 512):
                x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
                for odt in (torch.float32, bf):
                    _build.reset_launches()
                    got = D.dequant_matmul(x, qt, out_dtype=odt)
                    e = _err(got, D.dequant_matmul_reference(x, qt, odt))
                    ef = _err(got, x.float() @ w32)
                    fails += not e <= 2e-2
                    print(f"int{bits} M={m} {k}x{n} g{g} {str(odt)[6:]} "
                          f"{_tiles()}: err/plain {e:.2e} err/f32 {ef:.2e}",
                          flush=True)
    e, nl, k, n = 4, 3, 512, 768
    for bits in (4, 8):
        qt = _rand_qt(gen, k, n, bits, 128, (e * nl,))
        for m in (1, 5, 16, 130):
            for mode in ("concat", "psum"):
                for hl in (None, [0, 0, 0, 0, 0], [2, 3, 1, 1, 1],
                           [4, 0, 1, 2, 3]):
                    hot = (None if hl is None else
                           torch.tensor(hl, dtype=torch.int32, device="cuda"))
                    nh = e if hl is None else hl[0]
                    x = torch.randn((m, k) if mode == "concat" else (e, m, k),
                                    generator=gen, device="cuda")
                    if mode == "psum":
                        x[nh:] = float("nan")
                    x = x.to(bf)
                    for odt in (torch.float32, bf):
                        kw = dict(n_experts=e, stride=nl, mode=mode,
                                  out_dtype=odt, hot=hot)
                        _build.reset_launches()
                        got = D.dequant_matmul_moe(x, qt, 2, **kw)
                        ref = D.dequant_matmul_moe_reference(x, qt, 2, **kw)
                        err = _err(got, ref)
                        tail = (mode == "concat"
                                and bool(got.view(m, e, n)[:, nh:].any()))
                        fails += tail or not err <= 2e-2
                        print(f"moe int{bits} {mode} M={m} hot={hl} "
                              f"{str(odt)[6:]} {_tiles()}: err/plain "
                              f"{err:.2e}{' TAIL NOT ZERO' if tail else ''}",
                              flush=True)
    print(f"failures: {fails}")
    return int(fails > 0)


def _rotated(gen, k, n, bits=4, g=128):
    """Enough copies of a weight that cycling through them exceeds the L2
    cache twice, and a function giving the next."""
    first = _rand_qt(gen, k, n, bits, g)
    wb = first.codes.numel() + first.scales.numel() * 4
    qts = [first] + [_rand_qt(gen, k, n, bits, g)
                     for _ in range(max(0, math.ceil(100e6 / wb) - 1))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(qts)
        return qts[state["i"]]
    return qts, nxt, wb


def time_shapes(gen) -> None:
    import torch

    from quant_tpu_torch.kernels import _build
    from quant_tpu_torch.kernels import dequant_matmul as D
    from quant_tpu_torch.utils.timing import device_time

    bf = torch.bfloat16
    cc = _build.entry("dequant_matmul_cc", "dequant_matmul_launch",
                      D._ARGTYPES)
    sms = D._sm_count(torch.device("cuda"))

    def cuda_core(x, qt, odt):
        m, k = x.shape
        n = qt.n
        out = torch.empty((m, n), dtype=odt, device="cuda")
        splits, per = D._split_plan(m, k, n, qt.bits, sms=sms)
        partial = (torch.empty((m, n), dtype=torch.float32, device="cuda")
                   if splits > 1 and odt != torch.float32 else None)
        rc = cc(x.data_ptr(), 1, qt.codes.data_ptr(), qt.scales.data_ptr(),
                out.data_ptr(), int(odt == torch.float32),
                None if partial is None else partial.data_ptr(), m, k, n,
                qt.group_size, qt.bits, splits, per, None, 0,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "dequant_matmul", "dequant_matmul_cc")
        return out

    for m in (1, 8, 512):
        step = {"tc": 0.0, "cuda_core": 0.0, "bound": 0.0}
        for k, n, per, odt_name in LLAMA:
            odt = bf if odt_name == "bf16" else torch.float32
            qts, nxt, wb = _rotated(gen, k, n)
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
            iters = max(8, len(qts))
            tc = device_time(lambda: D.dequant_matmul(x, nxt(),
                                                      out_dtype=odt), iters)
            # the CUDA-core tile at M=512 lm_head takes seconds: not timed
            old = (device_time(lambda: cuda_core(x, nxt(), odt), iters)
                   if m < 512 or n < 100000 else float("nan"))
            bound = 1e3 * max((m * k * 2 + wb + m * n * 4) / HBM_BYTES_PER_S,
                              2 * m * k * n / BF16_FLOPS)
            dense = float("nan")
            if m == 512:
                w = qts[0].dequantize(bf)
                dense = device_time(lambda: torch.matmul(x, w), 8)
                del w
            print(f"M={m:<3d} {k}x{n}: tensor-core {tc:.4f} ms  cuda-core "
                  f"{old:.4f}  bound {bound:.4f} ({100 * bound / tc:.1f}%)  "
                  f"dense_bf16 {dense:.4f}", flush=True)
            step["tc"] += per * tc
            step["cuda_core"] += per * (old if old == old else 0.0)
            step["bound"] += per * bound
            del qts
            torch.cuda.empty_cache()
        print(f"step M={m}: " + "  ".join(f"{k} {v:.3f} ms"
                                          for k, v in step.items()))
    for mode, (k, n) in (("concat", (4096, 28672)), ("psum", (14336, 4096))):
        qt = _rand_qt(gen, k, n, 4, 128, (8,))
        wb = qt.codes.numel() + qt.scales.numel() * 4
        for m in (1, 8, 512):
            x = torch.randn((m, k) if mode == "concat" else (8, m, k),
                            generator=gen, device="cuda").to(bf)
            kw = dict(n_experts=8, stride=1, mode=mode,
                      out_dtype=bf if mode == "concat" else torch.float32)
            ms = device_time(lambda: D.dequant_matmul_moe(x, qt, 0, **kw), 4)
            print(f"moe mixtral {mode} M={m}: {ms:.4f} ms  bound "
                  f"{1e3 * wb / HBM_BYTES_PER_S:.4f}", flush=True)
        del qt
        torch.cuda.empty_cache()


def plan(gen) -> None:
    import torch

    from quant_tpu_torch.kernels import dequant_matmul as D
    from quant_tpu_torch.utils.timing import device_time

    real = D._sm_count
    for m in (1, 8):
        for k, n, _, odt_name in LLAMA:
            odt = torch.bfloat16 if odt_name == "bf16" else torch.float32
            qts, nxt, _ = _rotated(gen, k, n)
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            res = []
            try:
                for per_sm in (0.5, 1, 2, 3, 4, 6):
                    # the plan aims at 2 * sms blocks
                    D._sm_count = (lambda d, v=per_sm:
                                   max(1, int(real(d) * v / 2)))
                    parts, _ = D._tc_plan("tc_decode", m, k, n, 4,
                                          sms=D._sm_count(x.device))
                    ms = device_time(lambda: D.dequant_matmul(
                        x, nxt(), out_dtype=odt), max(8, len(qts)))
                    res.append(f"{per_sm}/SM: {parts} parts {ms:.4f} ms")
            finally:
                D._sm_count = real
            print(f"M={m} {k}x{n}: " + "  ".join(res), flush=True)
            del qts
            torch.cuda.empty_cache()


def ring() -> int:
    from quant_tpu_torch.kernels import _build

    src = pathlib.Path(__file__).resolve().parent / "ring_bandwidth.cu"
    with tempfile.TemporaryDirectory() as tmp:
        exe = pathlib.Path(tmp) / "ring_bandwidth"
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-o", str(exe), str(src)], check=True)
        return subprocess.run([str(exe)]).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "time", "plan", "ring"))
    args = ap.parse_args(argv)
    if args.mode == "ring":
        return ring()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dmm_probe measures the card; no CUDA device")
    from quant_tpu_torch.kernels import _build

    _build.build(("dequant_matmul", "dequant_matmul_cc"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.mode == "check":
        return check(gen)
    if args.mode == "time":
        time_shapes(gen)
    else:
        plan(gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
