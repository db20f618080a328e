"""Probe of the decode-attention kernels (``csrc/flash_decode.cu``,
``csrc/mla_attention.cu``) on one card.

    python -m quant_tpu_torch.tools.attn_probe time   # GQA rows, both paths
    python -m quant_tpu_torch.tools.attn_probe plan   # GQA chunk sizes
    python -m quant_tpu_torch.tools.attn_probe ramp   # GQA time by context
    python -m quant_tpu_torch.tools.attn_probe mla [time|plan|ramp ...]
    python -m quant_tpu_torch.tools.attn_probe time --kv-bits 4

``time`` gives the device time (``torch.profiler`` kernel events, each call
on the next layer of the stack, so L2-cold) of ``flash_decode_int8`` and
``paged_flash_decode_int8`` (pages 128 and 512) at B=8, Hkv=8, rep=4,
Dh=128 over the smoke's lengths (8014 tokens, 32 layers), at rep 8 (Hkv=4,
Qwen3-30B-A3B's heads) and over 8 slots of 8192 tokens (2 layers, 268 MB),
with bf16 q (the tensor-core path) and f32 q (the CUDA-core path), beside
each row's byte bound. ``plan`` times the bf16 rows under chunks of 64 to
512 tokens in place of :func:`decode_plan`'s choice. ``ramp`` times the
contiguous bf16 kernel with every slot at one length, 1 to 8192 tokens
(B=8, Hkv=8, rep=4): the intercept is the call's fixed cost (launch, the
first copies' latency, the merge), the slope its streaming rate. The GQA
modes run over the int8 cache, or with ``--kv-bits 4`` over the int4
head-pair cache (uint8 codes of Hkv/2 packed heads; each bound counts Dh
bytes of K and V codes a token and real head); run both in one call to
compare them on one card.

``mla`` does the same for ``mla_flash_decode_int8`` (all three by default):
``time`` at B=8, Dq=640, r=512 (DeepSeek's latent rows) over the smoke's
lengths and a 27-layer stack at H=16 (DeepSeek-V2-Lite) and H=128
(DeepSeek-V3), bf16 q (tensor cores) and f32 q (CUDA cores), and over 8
slots of 8192 tokens (4 layers, 168 MB) at H=16, beside each row's bound
(the latent bytes, or the operations at the bf16 peak); ``plan`` times the
bf16 rows under chunks of 64 to 2048 tokens and, at H=128, 16 and 32
heads a block, in place of :func:`mla_decode_plan`'s choice; ``ramp``
times every slot at one length, 1 to 2048 tokens, at H=16 and H=128: the
intercept is the call's fixed cost. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, 700 W (data sheet)
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
SMOKE_LENGTHS = [1, 100, 517, 1024, 1500, 2047, 2048, 777]


def _rows(gen, layers: int, b: int, hkv: int, s: int, d: int, lengths,
          kv_bits: int = 8):
    """A random int8 (or, ``kv_bits=4``, int4 head-pair) cache stack and its
    lengths on the card."""
    import torch

    def codes():
        if kv_bits == 4:
            return torch.randint(0, 256, (layers, b, hkv // 2, s, d),
                                 generator=gen, device="cuda",
                                 dtype=torch.int16).to(torch.uint8)
        return torch.randint(-127, 128, (layers, b, hkv, s, d), generator=gen,
                             device="cuda", dtype=torch.int8)

    def scales():
        return torch.rand((layers, b, hkv, s), generator=gen,
                          device="cuda") * 0.015 + 0.005
    cache = [codes(), scales(), codes(), scales()]
    return cache, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _pool(cache, lengths, page: int):
    """The cache's rows in a page pool under a shuffled table (seed 0)."""
    import numpy as np
    import torch

    layers, b, _, s, _ = cache[0].shape
    max_pages = s // page
    n_pool = 1 + b * max_pages
    used = [-(-int(n) // page) for n in lengths.tolist()]
    perm = np.random.default_rng(0).permutation(np.arange(1, n_pool))
    tbl = np.zeros((b, max_pages), np.int32)
    for i, u in enumerate(used):
        tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
    pool = []
    for a in cache:
        p = torch.zeros((layers, n_pool, a.shape[2], page)
                        + tuple(a.shape[4:]), dtype=a.dtype, device="cuda")
        for i, u in enumerate(used):
            for j in range(u):
                p[:, tbl[i, j]] = a[:, i, :, j * page:(j + 1) * page]
        pool.append(p)
    return pool, torch.from_numpy(tbl).to("cuda")


def _code_bytes(kv_bits: int, d: int) -> int:
    """K and V code bytes a token and real kv head."""
    return d if kv_bits == 4 else 2 * d


def _cases(gen, kv_bits: int = 8):
    """(name, layers, call(q, layer), q shape, bytes) of each timed row."""
    import torch

    from quant_tpu_torch.kernels.attention import flash_decode_int8
    from quant_tpu_torch.kernels.paged_attention import (
        paged_flash_decode_int8)

    out = []
    for name, layers, b, hkv, rep, s, lengths, pages in (
            ("smoke rows", 32, 8, 8, 4, 2048, SMOKE_LENGTHS, (128, 512)),
            ("rep 8", 32, 8, 4, 8, 2048, SMOKE_LENGTHS, ()),
            ("8 x 8192", 2, 8, 8, 4, 8192, [8192] * 8, (128,))):
        cache, ln = _rows(gen, layers, b, hkv, s, 128, lengths, kv_bits)
        n_tok = int(ln.sum())
        nbytes = n_tok * hkv * (_code_bytes(kv_bits, 128) + 8)
        out.append((f"{name} contiguous", layers, (b, hkv * rep, 128),
                    nbytes, lambda q, i, c=cache, ln=ln: flash_decode_int8(
                        q, *c, ln, i)))
        for page in pages:
            pool, tbl = _pool(cache, ln, page)
            out.append((f"{name} paged {page}", layers, (b, hkv * rep, 128),
                        nbytes, lambda q, i, p=pool, t=tbl, ln=ln:
                        paged_flash_decode_int8(q, *p, t, ln, i)))
        del cache
        torch.cuda.empty_cache()
    return out


def _time(call, layers: int, q) -> float:
    from quant_tpu_torch.utils.timing import kernel_times

    state = {"i": 0}

    def step():
        state["i"] = (state["i"] + 1) % layers
        return call(q, state["i"])
    return kernel_times(step, max(8, layers))[0]


def time_rows(gen, kv_bits: int = 8) -> None:
    import torch

    for name, layers, shape, nbytes, call in _cases(gen, kv_bits):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for qdt in (torch.bfloat16, torch.float32):
            q = torch.randn(shape, generator=gen, device="cuda").to(qdt)
            ms = _time(call, layers, q)
            print(f"kv{kv_bits} {name:28s} {str(qdt)[6:]:8s} {ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({100 * bound / ms:.0f}%)", flush=True)


def plan(gen, kv_bits: int = 8) -> None:
    import torch

    from quant_tpu_torch.kernels import attention, paged_attention

    real = attention.decode_plan
    cases = _cases(gen, kv_bits)
    for chunk in (64, 128, 256, 512):
        def forced(b, hkv, s, rep, dh, sms=132, window=0, kv4=False,
                   c=chunk):
            p = real(b, hkv, s, rep, dh, sms, window, kv4)
            if window > 0:
                s = min(s, window)
            hc, rows = (hkv // 2, 2 * rep) if kv4 else (hkv, rep)
            n = max(1, -(-s // c))
            parts = b * hc * n * rows if n > 1 else 0
            return attention.DecodePlan(c, n, b * hc * n, parts * dh,
                                        parts * 2, p.counters)
        attention.decode_plan = paged_attention.decode_plan = forced
        try:
            for name, layers, shape, nbytes, call in cases:
                q = torch.randn(shape, generator=gen,
                                device="cuda").to(torch.bfloat16)
                ms = _time(call, layers, q)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                print(f"kv{kv_bits} chunk {chunk:4d} {name:28s} {ms:.4f} ms "
                      f"({100 * bound / ms:.0f}% of bound)", flush=True)
        finally:
            attention.decode_plan = paged_attention.decode_plan = real
    print("decode_plan's own choices:",
          {n: real(8, 8, s, 4, 128, kv4=kv_bits == 4).chunk for n, s in
           (("S 2048", 2048), ("S 8192", 8192))})


def ramp(gen, kv_bits: int = 8) -> None:
    import torch

    from quant_tpu_torch.kernels.attention import (decode_plan,
                                                   flash_decode_int8)

    q = torch.randn((8, 32, 128), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for s, layers in ((2048, 32), (8192, 8)):
        cache, _ = _rows(gen, layers, 8, 8, s, 128, [s] * 8, kv_bits)
        chunk = decode_plan(8, 8, s, 4, 128, kv4=kv_bits == 4).chunk
        for n in sorted({1, 64, 128, 129, 256, 512, 1024, 2048, s}):
            if n > s:
                continue
            ln = torch.full((8,), n, dtype=torch.int32, device="cuda")
            ms = _time(lambda q, i: flash_decode_int8(q, *cache, ln, i),
                       layers, q)
            nbytes = 8 * 8 * n * (_code_bytes(kv_bits, 128) + 8)
            print(f"kv{kv_bits} S={s} chunk {chunk} length {n:5d}: "
                  f"{ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.0f} GB/s", flush=True)
        del cache
        torch.cuda.empty_cache()


MLA_DQ, MLA_R = 640, 512          # DeepSeek's latent row and value width


def _mla_cache(gen, layers: int, b: int, s: int):
    """A random int8 latent cache stack [L, B, 1, S, Dq] and its scales."""
    import torch

    kc = torch.randint(-127, 128, (layers, b, 1, s, MLA_DQ), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((layers, b, 1, s), generator=gen,
                    device="cuda") * 0.015 + 0.005
    return kc, ks


def _mla_bound(b: int, h: int, n_tok: int, qbytes: int) -> tuple[float, str]:
    """The least time of a call: q, the context's latent rows and scales,
    the lengths and the output once, or 2 H (Dq + r) operations a token."""
    nbytes = (b * h * MLA_DQ * qbytes + n_tok * (MLA_DQ + 4) + 4 * b
              + b * h * MLA_R * qbytes)
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = 2 * n_tok * h * (MLA_DQ + MLA_R) / BF16_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def _mla_rows(gen):
    """(name, h, layers, lengths, cache) of each timed MLA row."""
    rows = []
    for name, layers, s, lengths, heads in (
            ("smoke rows", 27, 2048, SMOKE_LENGTHS, (16, 128)),
            ("8 x 8192", 4, 8192, [8192] * 8, (16,))):
        cache = _mla_cache(gen, layers, 8, s)
        for h in heads:
            rows.append((f"{name} H={h}", h, layers, lengths, cache))
    return rows


def _mla_call(cache, lengths):
    import torch

    from quant_tpu_torch.kernels.mla_attention import mla_flash_decode_int8

    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return lambda q, i: mla_flash_decode_int8(q, *cache, ln, i, r=MLA_R,
                                              scale=0.0723)


def mla_time(gen) -> None:
    import torch

    from quant_tpu_torch.kernels.mla_attention import mla_decode_plan

    for name, h, layers, lengths, cache in _mla_rows(gen):
        call = _mla_call(cache, lengths)
        for qdt in (torch.bfloat16, torch.float32):
            q = torch.randn((8, h, MLA_DQ), generator=gen,
                            device="cuda").to(qdt)
            ms = _time(call, layers, q)
            bound, by = _mla_bound(8, h, sum(lengths), q.element_size())
            plan = mla_decode_plan(8, h, cache[0].shape[3], MLA_DQ, MLA_R,
                                   path="tc" if qdt == torch.bfloat16
                                   else "cuda_core")
            print(f"mla {name:18s} {str(qdt)[6:]:8s} {ms:.4f} ms  bound "
                  f"{bound:.4f} ms ({by}, {100 * bound / ms:.0f}%)  chunk "
                  f"{plan.chunk} heads/block {plan.heads}", flush=True)


def _mla_forced(chunk: int, heads: int | None):
    """A stand-in for :func:`mla_decode_plan` with the given chunk (and
    heads per block; None: the plan's own)."""
    from quant_tpu_torch.kernels import mla_attention

    real = mla_attention.mla_decode_plan

    def forced(b, hq, s, dq, r, sms=132, path="tc"):
        hb = heads or real(b, hq, s, dq, r, sms, path).heads
        g = -(-hq // hb)
        n = max(1, -(-s // chunk))
        parts = b * g * n * hb if n > 1 else 0
        return mla_attention.MlaDecodePlan(hb, g, chunk, n, b * g * n,
                                           parts * r, parts * 2, b * g)
    return forced


def _mla_time_under(plan, call, layers: int, q) -> float:
    """The call's device time with ``plan`` in place of mla_decode_plan
    (None: the plan's own choice); nan when the kernel refuses it."""
    from quant_tpu_torch.kernels import mla_attention

    real = mla_attention.mla_decode_plan
    if plan is not None:
        mla_attention.mla_decode_plan = plan
    try:
        return _time(call, layers, q)
    except RuntimeError as e:        # a split the kernel refuses
        print(f"  refused: {e}", flush=True)
        return float("nan")
    finally:
        mla_attention.mla_decode_plan = real


def mla_plan(gen) -> None:
    import torch

    from quant_tpu_torch.kernels.mla_attention import mla_decode_plan

    for name, h, layers, lengths, cache in _mla_rows(gen):
        call = _mla_call(cache, lengths)
        q = torch.randn((8, h, MLA_DQ), generator=gen,
                        device="cuda").to(torch.bfloat16)
        bound, _ = _mla_bound(8, h, sum(lengths), 2)
        own = mla_decode_plan(8, h, cache[0].shape[3], MLA_DQ, MLA_R)
        for heads in ((16, 32) if h > 16 else (16,)):
            for chunk in (64, 128, 256, 512, 1024, 2048):
                ms = _mla_time_under(_mla_forced(chunk, heads), call, layers,
                                     q)
                mark = (" <- mla_decode_plan" if (heads, chunk)
                        == (own.heads, own.chunk) else "")
                print(f"mla {name:18s} heads {heads:3d} chunk {chunk:4d} "
                      f"{ms:.4f} ms ({100 * bound / ms:.0f}% of bound){mark}",
                      flush=True)


def mla_ramp(gen) -> None:
    """Every slot at one length: under the plan's own split, as one chunk a
    slot (no merge: the tiles' serial time) and in 64-token chunks (every
    tile in its own block: the merge's cost)."""
    import torch

    cache = _mla_cache(gen, 8, 8, 2048)
    for h in (16, 128):
        q = torch.randn((8, h, MLA_DQ), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for n in (1, 64, 65, 128, 256, 512, 1024, 2048):
            call = _mla_call(cache, [n] * 8)
            own, one, split = (
                _mla_time_under(p, call, 8, q) for p in
                (None, _mla_forced(4096, None), _mla_forced(64, None)))
            nbytes = 8 * n * (MLA_DQ + 4)
            print(f"mla ramp H={h:3d} length {n:5d}: plan {own:.4f} ms "
                  f"({nbytes / own / 1e6:.0f} GB/s of latent rows), one "
                  f"chunk {one:.4f}, 64-token chunks {split:.4f}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("time", "plan", "ramp", "mla"))
    ap.add_argument("mla_modes", nargs="*", choices=("time", "plan", "ramp"),
                    help="with mla: which of its modes (default all)")
    ap.add_argument("--kv-bits", type=int, default=8, choices=(8, 4),
                    help="the GQA modes' cache: int8, or the int4 "
                         "head-pair cache")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device")
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.mode != "mla":
        {"time": time_rows, "plan": plan, "ramp": ramp}[args.mode](
            gen, args.kv_bits)
        return 0
    for mode in args.mla_modes or ("time", "plan", "ramp"):
        {"time": mla_time, "plan": mla_plan, "ramp": mla_ramp}[mode](gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
