"""The port's kernel modules against the JAX Pallas kernels (CPU).

Each plain PyTorch version is held against the JAX function run as the JAX
package's own tests run it (``interpret=True``), on the same numpy inputs
made from a seeded ``np.random.default_rng``. The ``gpu``-marked test holds
each CUDA kernel against its plain version on the card; a machine with a card
but without JAX runs them alone, without the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from quant_tpu.core.qtensor import quantize_tensor as j_quantize
    from quant_tpu.kernels.attention import flash_decode_int8 as j_flash
    from quant_tpu.kernels.cache_insert import cache_insert_int8 as j_insert
    from quant_tpu.kernels.dequant_matmul import dequant_matmul as j_dqmm
    from quant_tpu.kernels.unpack import unpack_int4_device as j_unpack
except ModuleNotFoundError:   # only the gpu-marked test can run there
    pass

from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels.attention import (flash_decode_int8,
                                               flash_decode_int8_reference)
from quant_tpu_torch.kernels.cache_insert import (
    cache_insert_int8, cache_insert_int8_reference)
from quant_tpu_torch.kernels.cache_insert import (
    paged_cache_insert_int8, paged_cache_insert_int8_reference)
from quant_tpu_torch.kernels.cache_insert import (
    mla_cache_insert_int8, mla_cache_insert_int8_reference)
from quant_tpu_torch.kernels.dequant_matmul import (
    dequant_matmul, dequant_matmul_moe, dequant_matmul_moe_reference,
    dequant_matmul_reference)
from quant_tpu_torch.kernels.mla_attention import (
    mla_flash_decode_int8, mla_flash_decode_int8_reference)
from quant_tpu_torch.kernels.paged_attention import (
    paged_attention_reference, paged_flash_decode_int8)
from quant_tpu_torch.kernels.unpack import (unpack_int4_device,
                                            unpack_int4_host,
                                            unpack_int4_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qt_pair(rng, bits, k, n, g, layers):
    """(JAX QTensor, port QTensor) of the same codes; stacked [L, ...] when
    ``layers`` is set."""
    qs = [j_quantize(rng.standard_normal((k, n), dtype=np.float32), bits,
                     group_size=g) for _ in range(layers or 1)]
    if layers:
        jq = jax.tree.map(lambda *a: np.stack(a), *qs)
    else:
        jq = qs[0]
    tq = QTensor(codes=torch.from_numpy(np.asarray(jq.codes)),
                 scales=torch.from_numpy(np.asarray(jq.scales)), bits=bits,
                 group_size=g, shape=(k, n))
    return jq, tq


# (bits, stacked, M, K, N, G): every value of each axis appears
_MM_CASES = [
    (4, False, 1, 256, 512, 64),
    (4, True, 5, 512, 256, 128),
    (4, True, 130, 256, 384, 64),
    (4, False, 130, 512, 512, 128),
    (8, False, 5, 256, 256, 64),
    (8, True, 1, 512, 384, 128),
    (8, True, 130, 256, 512, 128),
    (8, False, 1, 512, 256, 64),
]


@pytest.mark.parametrize("bits,stacked,m,k,n,g", _MM_CASES)
def test_dequant_matmul_matches_jax(bits, stacked, m, k, n, g):
    rng = np.random.default_rng(m * 1000 + k + n + g + bits)
    jq, tq = _qt_pair(rng, bits, k, n, g, 3 if stacked else 0)
    x = rng.standard_normal((m, k), dtype=np.float32)
    layer = 2 if stacked else None
    ref = np.asarray(j_dqmm(jnp.asarray(x), jq,
                            None if layer is None else jnp.int32(layer),
                            interpret=True))
    got = dequant_matmul(torch.from_numpy(x), tq, layer)
    plain = dequant_matmul_reference(
        torch.from_numpy(x), tq.layer(layer) if stacked else tq)
    assert torch.equal(got, plain)   # the CPU dispatch is the plain version
    assert got.shape == (m, n) and got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= 1e-5 * np.max(np.abs(ref)), err


def _cache(rng, l, b, h, s, d):
    return (rng.integers(-127, 128, (l, b, h, s, d), dtype=np.int8),
            rng.standard_normal((l, b, h, s), dtype=np.float32),
            rng.integers(-127, 128, (l, b, h, s, d), dtype=np.int8),
            rng.standard_normal((l, b, h, s), dtype=np.float32))


@pytest.mark.parametrize("s0,lengths", [(0, [3, 127, 128, 50]),
                                        (64, [3, 100, 191, 250])])
def test_cache_insert_matches_jax(s0, lengths):
    """Byte-equal; rows at or past S, or before s0, are dropped."""
    rng = np.random.default_rng(11 + s0)
    l, b, h, s, d = 3, 4, 2, 128, 64
    cache = _cache(rng, l, b, h, s, d)
    kn = rng.integers(-127, 128, (b, 1, h, d), dtype=np.int8)
    kns = rng.standard_normal((b, 1, h), dtype=np.float32)
    vn = rng.integers(-127, 128, (b, 1, h, d), dtype=np.int8)
    vns = rng.standard_normal((b, 1, h), dtype=np.float32)
    ln = np.asarray(lengths, np.int32)
    ref = j_insert(*[jnp.asarray(a) for a in cache], jnp.asarray(kn),
                   jnp.asarray(kns), jnp.asarray(vn), jnp.asarray(vns),
                   jnp.asarray(ln), jnp.int32(1), s0, interpret=True)
    tc = [torch.from_numpy(a.copy()) for a in cache]
    got = cache_insert_int8(*tc, torch.from_numpy(kn), torch.from_numpy(kns),
                            torch.from_numpy(vn), torch.from_numpy(vns),
                            torch.from_numpy(ln), 1, s0)
    for g_, r_, t_ in zip(got, ref, tc):
        assert g_ is t_                  # written in place
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    dropped = [i for i, n in enumerate(lengths) if not 0 <= n - s0 < s]
    for i in dropped:
        np.testing.assert_array_equal(got[0][:, i].numpy(), cache[0][:, i])


@pytest.mark.parametrize("rep", [2, 4])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_decode_matches_jax(rep, dh):
    """Lengths of 1 token, a partial block and the full S."""
    rng = np.random.default_rng(rep * 10 + dh)
    l, b, hkv, s = 2, 3, 2, 128
    kc, ks, vc, vs = _cache(rng, l, b, hkv, s, dh)
    ks, vs = np.abs(ks) * 0.02, np.abs(vs) * 0.02
    q = rng.standard_normal((b, hkv * rep, dh), dtype=np.float32)
    ln = np.asarray([1, 37, s], np.int32)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks),
                             jnp.asarray(vc), jnp.asarray(vs),
                             jnp.asarray(ln), jnp.int32(1), interpret=True,
                             precision="highest", s_blk=64))
    args = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, ln)]
    got = flash_decode_int8(*args, 1)
    assert got.shape == (b, hkv * rep, dh) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5


def test_flash_decode_zero_length_is_finite():
    rng = np.random.default_rng(5)
    kc, ks, vc, vs = _cache(rng, 1, 2, 2, 64, 64)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64), dtype=np.float32))
    out = flash_decode_int8_reference(
        q, *[torch.from_numpy(a) for a in (kc, ks, vc, vs)],
        torch.tensor([0, 5], dtype=torch.int32), 0)
    assert torch.isfinite(out).all() and torch.all(out[0] == 0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version at small shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _build.build()
    for bits in (4, 8):
        for m in (1, 5, 130):
            k, n, g = 512, 768, 128
            kp = k // 2 if bits == 4 else k
            codes = torch.randint(0, 256, (kp, n), generator=gen, device=dev,
                                  dtype=torch.int32)
            codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(
                torch.int8)
            qt = QTensor(codes=codes, scales=torch.rand(
                (k // g, n), generator=gen, device=dev) * 0.1, bits=bits,
                group_size=g, shape=(k, n))
            # bf16 out (wqkv, w_gate_up in the forward) takes the kernel's
            # bf16 stores: through the split-K buffer at decode M, direct
            # at prefill M
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                for odt in (torch.float32, torch.bfloat16):
                    ref = dequant_matmul_reference(x, qt, odt).float()
                    got = dequant_matmul(x, qt, out_dtype=odt)
                    assert got.dtype == odt
                    tol = (1e-4 if dt == odt == torch.float32 else 2e-2)
                    assert ((got.float() - ref).abs().max()
                            <= tol * ref.abs().max())
    # Llama-3-8B's head geometry and test-tiny's; S spans several of the
    # flash kernel's 256-token chunks, the last one partial
    for s, d, rep in ((600, 128, 4), (300, 64, 2)):
        l, b, h = 2, 4, 2
        cache = [t.to(dev) for t in (
            torch.randint(-127, 128, (l, b, h, s, d), dtype=torch.int8),
            torch.rand((l, b, h, s)) * 0.02,
            torch.randint(-127, 128, (l, b, h, s, d), dtype=torch.int8),
            torch.rand((l, b, h, s)) * 0.02)]
        plain = [t.clone() for t in cache]
        new = [t.to(dev) for t in (
            torch.randint(-127, 128, (b, 1, h, d), dtype=torch.int8),
            torch.rand((b, 1, h)),
            torch.randint(-127, 128, (b, 1, h, d), dtype=torch.int8),
            torch.rand((b, 1, h)))]
        ln = torch.tensor([0, 17, 257, s], dtype=torch.int32, device=dev)
        cache_insert_int8(*cache, *new, ln, 1)
        cache_insert_int8_reference(*plain, *new, ln, 1)
        for a, r in zip(cache, plain):
            assert torch.equal(a, r)
        q = torch.randn((b, h * rep, d), generator=gen, device=dev)
        got = flash_decode_int8(q, *cache, ln, 1)
        ref = flash_decode_int8_reference(q, *cache, ln, 1)
        torch.cuda.synchronize()
        assert (got - ref).abs().max() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16, 128])
def test_paged_cuda_kernels_match_plain_on_card(page):
    """The paged insert (byte-equal, with a slot at capacity and a parked
    slot) and paged flash decode (f32 and bf16 q) against their plain
    versions; a 256-token chunk spans several pages or part of one, and
    table entries past each slot's pages point at the scratch page 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(page)
    _build.build()
    for d, rep in ((128, 4), (64, 2)):
        l, h, max_pages = 2, 2, -(-600 // page)
        cap = max_pages * page
        lengths = [0, 17, 257, 599, cap]
        b = len(lengths)
        n_pool = 1 + b * max_pages
        used = [-(-n // page) for n in lengths]
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
        for i, u in enumerate(used):
            tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
        pool = [torch.randint(-127, 128, (l, n_pool, h, page, d),
                              generator=gen, device=dev, dtype=torch.int8),
                torch.rand((l, n_pool, h, page), generator=gen,
                           device=dev) * 0.02,
                torch.randint(-127, 128, (l, n_pool, h, page, d),
                              generator=gen, device=dev, dtype=torch.int8),
                torch.rand((l, n_pool, h, page), generator=gen,
                           device=dev) * 0.02]
        plain = [t.clone() for t in pool]
        new = [torch.randint(-127, 128, (b, 1, h, d), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.rand((b, 1, h), generator=gen, device=dev),
               torch.randint(-127, 128, (b, 1, h, d), generator=gen,
                             device=dev, dtype=torch.int8),
               torch.rand((b, 1, h), generator=gen, device=dev)]
        # insert at each slot's length: slot 0 is parked, the last at
        # capacity
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        paged_cache_insert_int8(*pool, *new, ln, 1, tbl)
        paged_cache_insert_int8_reference(*plain, *new, ln, 1, tbl)
        for a, r in zip(pool, plain):
            assert torch.equal(a, r)
        for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q = torch.randn((b, h * rep, d), generator=gen,
                            device=dev).to(qdt)
            got = paged_flash_decode_int8(q, *pool, tbl, ln, 1)
            ref = paged_attention_reference(q, *pool, tbl, ln, 1)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max()
            assert err <= tol * ref.float().abs().max()
            assert not got[0].float().abs().max()


def _rand_stack(gen, dev, entries, k, n, bits, g=128):
    kp = k // 2 if bits == 4 else k
    codes = torch.randint(0, 256, (entries, kp, n), generator=gen, device=dev,
                          dtype=torch.int32)
    codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(
        torch.int8)
    scales = torch.rand((entries, k // g, n), generator=gen, device=dev) * 0.1
    return QTensor(codes=codes, scales=scales, bits=bits, group_size=g,
                   shape=(k, n))


def _nan_block(shape, dtype, dev) -> int:
    """Leave a NaN-filled block of ``shape`` in the caching allocator; the
    next allocation of that size reuses it. Returns its address."""
    blk = torch.full(shape, float("nan"), dtype=dtype, device=dev)
    ptr = blk.data_ptr()
    del blk
    return ptr


@pytest.mark.gpu
def test_moe_cuda_kernel_matches_plain_on_card():
    """dequant_matmul_moe against its plain version: concat and psum, int4
    and int8, M at decode and prefill sizes, bf16 and f32 out, with and
    without a hot list. The output buffer is handed out NaN-filled, and the
    tail slots' x rows are NaN in psum: the tail must come out exactly zero
    (concat) or not at all (psum). Then the last expert of the last layer
    of a stack holding more than 2^32 bytes of codes (64-bit offsets),
    where the card has the memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    _build.build()
    e, nl, k, n = 4, 3, 512, 768
    hot = torch.tensor([2, 3, 1, 1, 1], dtype=torch.int32, device=dev)
    for bits in (4, 8):
        qt = _rand_stack(gen, dev, e * nl, k, n, bits)
        for m in (1, 5, 130):
            for mode in ("concat", "psum"):
                for h in (None, hot):
                    shape = (m, k) if mode == "concat" else (e, m, k)
                    x = torch.randn(shape, generator=gen, device=dev)
                    if h is not None and mode == "psum":
                        x[2:] = float("nan")
                    for odt in (torch.float32, torch.bfloat16):
                        xb = x.to(torch.bfloat16)
                        kw = dict(n_experts=e, stride=nl, mode=mode,
                                  out_dtype=odt, hot=h)
                        ref = dequant_matmul_moe_reference(
                            xb, qt, 2, **kw).float()
                        width = e * n if mode == "concat" else n
                        ptr = _nan_block((m, width), odt, dev)
                        got = dequant_matmul_moe(xb, qt, 2, **kw)
                        torch.cuda.synchronize()
                        assert got.data_ptr() == ptr and got.dtype == odt
                        assert torch.isfinite(got).all()
                        if mode == "concat" and h is not None:
                            assert not got.view(m, e, n)[:, 2:].any()
                        err = (got.float() - ref).abs().max()
                        assert err <= 2e-2 * ref.abs().max(), (
                            bits, m, mode, h is not None, odt)
    # 64-bit offsets: 2 layers of 4 experts, 671 MB of int4 codes each
    k, n = 8192, 163840
    need = 8 * (k // 2) * n + 8 * (k // 128) * n * 4 + 6 * k * n * 4
    if torch.cuda.mem_get_info()[0] < need:
        return
    qt = QTensor(codes=torch.empty((8, k // 2, n), dtype=torch.uint8,
                                   device=dev),
                 scales=torch.rand((8, k // 128, n), generator=gen,
                                   device=dev) * 0.1,
                 bits=4, group_size=128, shape=(k, n))
    assert qt.codes.numel() > 2 ** 32
    qt.codes[7] = torch.randint(0, 256, (k // 2, n), generator=gen,
                                device=dev, dtype=torch.int32).to(torch.uint8)
    last = torch.tensor([1, 3, 3, 3, 3], dtype=torch.int32, device=dev)
    x = torch.randn((4, 1, k), generator=gen, device=dev).to(torch.bfloat16)
    ref = dequant_matmul_reference(x[0], qt.layer(7), torch.float32)
    for mode, xs in (("concat", x[0]), ("psum", x)):
        got = dequant_matmul_moe(xs, qt, 1, n_experts=4, stride=2, mode=mode,
                                 out_dtype=torch.float32, hot=last)
        torch.cuda.synchronize()
        got = got[:, :n] if mode == "concat" else got
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), mode


@pytest.mark.gpu
@pytest.mark.parametrize("h,r,dq", [(4, 64, 128), (16, 512, 640),
                                    (128, 512, 640)])
def test_mla_cuda_kernels_match_plain_on_card(h, r, dq):
    """The MLA latent insert (byte-equal, with a slot at capacity and one
    outside the shard) and MLA flash decode (f32 q within 1e-4 of
    max|ref|, bf16 q within 1e-2) against their plain versions at the toy
    shapes (test-tiny-mla), DeepSeek-V2-Lite's (16 heads) and
    DeepSeek-V3's (128 heads: 8 head tiles); S spans several 64-token
    tiles and chunks, the last one partial."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(h)
    _build.build()
    l, s = 3, 600
    lengths = [0, 1, 65, 300, s - 1, s]
    b = len(lengths)
    kc = torch.randint(-127, 128, (l, b, 1, s, dq), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int8)
    ks = torch.rand((l, b, 1, s), generator=gen, device=dev) * 0.02
    plain = [kc.clone(), ks.clone()]
    new_c = torch.randint(-127, 128, (b, 1, 1, dq), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.int8)
    new_s = torch.rand((b, 1, 1), generator=gen, device=dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for s0 in (0, 64):
        mla_cache_insert_int8(kc, ks, new_c, new_s, ln, 1, s0)
        mla_cache_insert_int8_reference(*plain, new_c, new_s, ln, 1, s0)
        assert torch.equal(kc, plain[0]) and torch.equal(ks, plain[1])
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn((b, h, dq), generator=gen, device=dev).to(qdt)
        got = mla_flash_decode_int8(q, kc, ks, ln, 1, r=r, scale=0.07)
        ref = mla_flash_decode_int8_reference(q, kc, ks, ln, 1, r=r,
                                              scale=0.07)
        torch.cuda.synchronize()
        assert got.dtype == qdt and got.shape == (b, h, r)
        err = (got.float() - ref.float()).abs().max()
        assert err <= tol * ref.float().abs().max(), (qdt, float(err))
        assert not got[0].float().abs().max()


@pytest.mark.parametrize("k,n", [(512, 512), (64, 1536), (6, 10)])
def test_unpack_int4_reference_matches_jax_kernel(k, n):
    """The plain unpack (the CPU path of ``unpack_int4_device``) equals the
    JAX Pallas kernel in interpret mode and the host codec bit for bit;
    unpacking the numpy codec's packing gives the codes back."""
    from quant_tpu_torch.core import codec

    codes = np.random.default_rng(k + n).integers(-8, 8, (k, n)).astype(
        np.int8)
    packed = codec.pack_int4_matmul(codes)
    want = np.asarray(j_unpack(jnp.asarray(packed), interpret=True))
    got = unpack_int4_device(torch.from_numpy(packed)).numpy()
    assert got.dtype == np.int8 and got.shape == (k, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(unpack_int4_host(packed), codes)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(512, 512), (64, 1536), (6, 10),
                                 (4096, 28672)])
def test_unpack_cuda_kernel_matches_plain_on_card(k, n):
    """``unpack_int4_device`` against its plain version and the host codec,
    bit for bit: the 16-byte vector path (K/2·N a multiple of 16), the
    bytewise path (6x10: 30 bytes) and an offset view (layer 1 of a stack,
    vector path only when its start stays 16-byte aligned)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(k + n)
    _build.build(("unpack",))
    stack = torch.randint(0, 256, (2, k // 2, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    for packed in (stack[0], stack[1]):
        got = unpack_int4_device(packed)
        ref = unpack_int4_reference(packed)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and got.shape == (k, n)
        assert torch.equal(got, ref)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      unpack_int4_host(packed.cpu().numpy()))
