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
    from quant_tpu.kernels.cache_insert import (
        paged_cache_insert_int8 as j_paged_insert)
    from quant_tpu.kernels.dequant_matmul import dequant_matmul as j_dqmm
    from quant_tpu.kernels.unpack import unpack_int4_device as j_unpack
    from quant_tpu.models import llama as jllama
except ModuleNotFoundError:   # only the gpu-marked test can run there
    pass

from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels import attention as att
from quant_tpu_torch.kernels.attention import (flash_decode_int8,
                                               flash_decode_int8_reference)
from quant_tpu_torch.kernels.cache_insert import (
    cache_insert_int8_fused, cache_insert_int8_fused_reference,
    cache_insert_int8_reference, paged_cache_insert_int8_fused,
    paged_cache_insert_int8_fused_reference)
from quant_tpu_torch.kernels.cache_insert import (
    mla_cache_insert_int8_fused, mla_cache_insert_int8_fused_reference)
from quant_tpu_torch.kernels import dequant_matmul as dmm
from quant_tpu_torch.kernels import mla_attention as mla
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
from quant_tpu_torch.models import PRESETS
from quant_tpu_torch.models.llama import _rope_tables


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


# (K, N, G) of the projections chip_smoke.py drives through the tensor-core
# tiles (Llama-3-8B, DeepSeek-V2-Lite, DeepSeek-V3) and (E, K, N, mode) of
# its expert stacks (Mixtral-8x7B, Qwen3-30B-A3B, DeepSeek-V2-Lite and -V3)
_PLAN_DENSE = [(4096, 6144, 128), (4096, 4096, 128), (4096, 28672, 128),
               (14336, 4096, 128), (4096, 131072, 128), (2048, 3648, 64),
               (2048, 2048, 64), (2048, 5632, 64), (2816, 2048, 64),
               (2048, 21888, 64), (10944, 2048, 64), (2048, 102400, 64),
               (7168, 2112, 128), (1536, 24576, 128), (16384, 7168, 128),
               (7168, 36864, 128), (18432, 7168, 128), (7168, 129280, 128)]
_PLAN_MOE = [(8, 4096, 28672, "concat"), (8, 14336, 4096, "psum"),
             (128, 2048, 1536, "concat"), (128, 1024, 2048, "psum"),
             (64, 2048, 2816, "concat"), (64, 2048, 2048, "psum"),
             (256, 7168, 4096, "concat"), (256, 2048, 7168, "psum")]


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 64, 512])
def test_tensor_core_plan_covers_k_once(m):
    """The tensor-core tiles' split plan at the smoke's shapes: whole stages,
    no empty partition, every packed row in exactly one, and a grid within
    CUDA's limits."""
    tile = "tc_decode" if m <= dmm._TC_DECODE_M else "tc_prefill"
    bkp = dmm._TC_BKP[tile]
    cases = [(k, n, 1, False) for k, n, _ in _PLAN_DENSE]
    cases += [(k, n, e, mode != "concat") for e, k, n, mode in _PLAN_MOE]
    for k, n, slots, sum_mode in cases:
        parts, per = dmm._tc_plan(tile, m, k, n, 4, slots, sum_mode)
        kp_pad = -(-(k // 2) // bkp) * bkp
        total = kp_pad * (slots if sum_mode else 1)
        assert per % bkp == 0 and parts >= 1
        assert (parts - 1) * per < total <= parts * per, (k, n, slots)
        grid_z = parts if sum_mode else slots * parts
        assert grid_z <= 65535                      # CUDA's grid z limit
        assert dmm._out_tiles(tile, m, n) * grid_z < 2 ** 31
    # the tile each call takes: bf16 x with K/2, G and N multiples of 16
    for (k, n, g), dt, want in (((512, 768, 128), torch.bfloat16, tile),
                                ((512, 768, 128), torch.float32, "cuda_core"),
                                ((512, 4, 128), torch.bfloat16, "cuda_core"),
                                ((512, 768, 8), torch.bfloat16, "cuda_core"),
                                ((192, 64, 64), torch.bfloat16, tile)):
        qt = QTensor(codes=torch.zeros((k // 2, n), dtype=torch.uint8),
                     scales=torch.ones((k // g, n)), bits=4, group_size=g,
                     shape=(k, n))
        assert dmm._tile(torch.zeros((m, k), dtype=dt), qt, m) == want


def _cache(rng, l, b, h, s, d):
    return (rng.integers(-127, 128, (l, b, h, s, d), dtype=np.int8),
            rng.standard_normal((l, b, h, s), dtype=np.float32),
            rng.integers(-127, 128, (l, b, h, s, d), dtype=np.int8),
            rng.standard_normal((l, b, h, s), dtype=np.float32))


@pytest.mark.parametrize("s0,lengths", [(0, [3, 127, 128, 50]),
                                        (64, [3, 100, 191, 250])])
def test_cache_insert_matches_jax(s0, lengths):
    """The codes-in plain insert (which the fused insert's plain version
    runs after RoPE and quantization) byte-equal to the JAX kernel; rows at
    or past S, or before s0, are dropped."""
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
    got = cache_insert_int8_reference(
        *tc, torch.from_numpy(kn), torch.from_numpy(kns), torch.from_numpy(vn),
        torch.from_numpy(vns), torch.from_numpy(ln), 1, s0)
    for g_, r_, t_ in zip(got, ref, tc):
        assert g_ is t_                  # written in place
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    dropped = [i for i, n in enumerate(lengths) if not 0 <= n - s0 < s]
    for i in dropped:
        np.testing.assert_array_equal(got[0][:, i].numpy(), cache[0][:, i])


# the fused insert: (layout, s0 or page, Dh) in float32 and bfloat16 at rep
# 1 and 4; the contiguous cache at s0 0 and 64 with Dh 64 (the shapes of
# test_cache_insert_matches_jax, whose JAX kernel build it shares) and 128,
# the page pool at pages 8 (Dh 128) and 16 (Dh 64)
_FUSED_CASES = [(layout, at, dh, dtype, rep)
                for layout, at, dh in (("contiguous", 0, 64),
                                       ("contiguous", 0, 128),
                                       ("contiguous", 64, 64),
                                       ("contiguous", 64, 128),
                                       ("paged", 8, 128), ("paged", 16, 64))
                for dtype in ("float32", "bfloat16") for rep in (1, 4)]
_THETA = 500000.0


def _fused_inputs(layout, at, dh):
    """(projection row [B, 1, (8 + 2 Hkv) Dh] f32 at rep 4, caches, lengths,
    page table or None) of one layout: 4 slots, Hkv 2 (the rotary and
    quantizer inputs of a Dh and dtype have one shape for every layout, so
    the JAX chain is traced once for each). Contiguous: S 128, a slot whose
    row lies past S or before s0 (dropped). Paged: 32 tokens a slot, one
    writing on its third page (at page 8), one at capacity (dropped) and a
    parked one (length 0, table row 0: its row goes to the scratch page
    0)."""
    rng = np.random.default_rng([at, dh])
    b, hkv = 4, 2
    row = rng.standard_normal((b, 1, (4 * hkv + 2 * hkv) * dh),
                              dtype=np.float32)
    if layout == "contiguous":
        lengths = [3, 127, 128, 0] if at == 0 else [3, 100, 191, 64]
        return (row, _cache(rng, 3, b, hkv, 128, dh),
                np.asarray(lengths, np.int32), None)
    max_pages = 32 // at
    lengths = np.asarray([19, max_pages * at, 0, 5], np.int32)
    n_pool = 1 + b * max_pages
    cache = _cache(rng, 2, n_pool, hkv, at, dh)
    perm = rng.permutation(np.arange(1, n_pool)).reshape(b, max_pages)
    used = -(-lengths // at)
    tbl = np.where(np.arange(max_pages)[None] < used[:, None], perm, 0)
    return row, cache, lengths, tbl.astype(np.int32)


def _qkv(row, rep, dh, cat):
    """q [B, 1, 2 rep, Dh] (the first heads of rep 4's), k and v [B, 1, 2,
    Dh] of a rep-4 projection row; in torch, views of one projection row
    at ``rep``."""
    b, hq = row.shape[0], 2 * rep
    row = cat([row[..., :hq * dh], row[..., 8 * dh:]], -1)
    return (row[..., :hq * dh].reshape(b, 1, hq, dh),
            row[..., hq * dh:(hq + 2) * dh].reshape(b, 1, 2, dh),
            row[..., (hq + 2) * dh:].reshape(b, 1, 2, dh))


def _jax_chain(q, k, v, pos):
    """The JAX forward's RoPE of q and k and ``quantize_kv`` of k and v,
    eagerly (under ``jax.jit`` XLA may divide by another rounding of the
    scale, which moves codes at ties)."""
    q = jllama._rope(q, pos, _THETA)
    kq, ks = jllama.quantize_kv(jllama._rope(k, pos, _THETA))
    return (q, kq, ks, *jllama.quantize_kv(v))


@pytest.fixture(scope="module")
def jax_fused():
    """(layout, s0 or page, Dh, dtype) -> (rotated q of rep 4 as f32, caches
    after the insert): the JAX chain ``_rope`` of q and k, ``quantize_kv``
    of k and v, then the Pallas insert (contiguous or paged) with
    ``interpret=True``. The rep-1 cases read the first heads of the q."""
    out = {}
    for layout, at, dh, dtype, rep in _FUSED_CASES:
        if rep != 4:
            continue
        row, cache, lengths, tbl = _fused_inputs(layout, at, dh)
        q, k, v = _qkv(jnp.asarray(row).astype(getattr(jnp, dtype)), 4, dh,
                       jnp.concatenate)
        q, kq, ks, vq, vs = _jax_chain(q, k, v,
                                       jnp.asarray(lengths[:, None]))
        args = [jnp.asarray(a) for a in cache] + [kq, ks, vq, vs,
                                                  jnp.asarray(lengths),
                                                  jnp.int32(1)]
        res = (j_insert(*args, at, interpret=True) if tbl is None else
               j_paged_insert(*args, jnp.asarray(tbl), interpret=True))
        out[layout, at, dh, dtype] = (np.asarray(q[:, 0].astype(jnp.float32)),
                                      [np.asarray(a) for a in res])
    return out


@pytest.mark.parametrize("layout,at,dh,dtype,rep", _FUSED_CASES)
def test_fused_insert_matches_jax(jax_fused, layout, at, dh, dtype, rep):
    """The fused insert on the CPU (its plain version: the port's RoPE,
    ``quantize_kv`` and codes-in insert) against the JAX chain, with q, k
    and v as views of one projection row: the rotated q within 1e-5 in
    float32 (``test_rope_matches_jax``: cos/sin of one float32 angle in two
    libraries) and within one bfloat16 step (2**-7 of |q|, plus 1e-5) in
    bfloat16; cache codes equal except in at most 0.1% of the written
    entries, which differ by exactly 1 (a rounding tie of the quantizer,
    ``tests/test_torch_llama.py``'s rule), scales within 1e-5 relative,
    and every entry that was not written untouched."""
    ref_q, ref_cache = jax_fused[layout, at, dh, dtype]
    ref_q = ref_q[:, :2 * rep]
    row, cache, lengths, tbl = _fused_inputs(layout, at, dh)
    q, k, v = _qkv(torch.from_numpy(row).to(getattr(torch, dtype)), rep, dh,
                   torch.cat)
    assert not (q.is_contiguous() or k.is_contiguous()
                or v.is_contiguous())
    cos, sin = _rope_tables(torch.from_numpy(lengths)[:, None], _THETA, dh)
    ln = torch.from_numpy(lengths)
    got_cache = [torch.from_numpy(a.copy()) for a in cache]
    plain_cache = [torch.from_numpy(a.copy()) for a in cache]
    if tbl is None:
        got = cache_insert_int8_fused(q, k, v, cos, sin, *got_cache, ln, 1,
                                      at)
        plain = cache_insert_int8_fused_reference(
            q, k, v, cos, sin, *plain_cache, ln, 1, at)
    else:
        t = torch.from_numpy(tbl)
        got = paged_cache_insert_int8_fused(q, k, v, cos, sin, *got_cache,
                                            ln, 1, t)
        plain = paged_cache_insert_int8_fused_reference(
            q, k, v, cos, sin, *plain_cache, ln, 1, t)
    # the CPU dispatch is the plain version
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(got_cache, plain_cache))
    assert got.dtype == q.dtype and got.shape == (len(lengths), 2 * rep, dh)
    g = got.float().numpy()
    if dtype == "float32":
        assert np.max(np.abs(g - ref_q)) <= 1e-5
    else:
        assert np.all(np.abs(g - ref_q) <= 2.0 ** -7 * np.abs(ref_q) + 1e-5)
    # [L, B or P, H, S or page]: the rows the step writes (layer 1)
    rows = np.zeros(cache[1].shape, bool)
    for b, n in enumerate(lengths):
        if tbl is None and 0 <= n - at < rows.shape[3]:
            rows[1, b, :, n - at] = True
        elif tbl is not None and n < tbl.shape[1] * at:
            rows[1, tbl[b, n // at], :, n % at] = True
    assert rows.sum() == 2 * (len(lengths) - 1)   # one slot drops its row
    for i in (0, 2):
        t_c, j_c = got_cache[i].numpy(), ref_cache[i]
        np.testing.assert_array_equal(t_c[~rows], cache[i][~rows])
        np.testing.assert_array_equal(j_c[~rows], cache[i][~rows])
        d = np.abs(t_c[rows].astype(np.int32) - j_c[rows].astype(np.int32))
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (i, np.sum(d > 0))
    for i in (1, 3):
        np.testing.assert_allclose(got_cache[i].numpy(), ref_cache[i],
                                   rtol=1e-5, atol=0)


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


_SMOKE_LENGTHS = [1, 100, 517, 1024, 1500, 2047, 2048, 777]


@pytest.mark.parametrize("s,page", [(2048, None), (8192, None), (2048, 8),
                                    (2048, 16), (2048, 128), (8192, 512)])
def test_decode_plan_covers_each_token_once(s, page):
    """The decode-attention plan, walked as the kernel walks it (blocks
    exit at or past a slot's length, tiles of ``_TILE`` tokens, a paged
    block reading the table entries of its own tokens' pages): each valid
    token in exactly one block, no table entry past a slot's pages, a grid
    within CUDA's limits, and the workspace sized from static ints alone."""
    for b, hkv, rep, dh in ((8, 8, 4, 128), (8, 4, 8, 128), (3, 2, 1, 64),
                            (1, 16, 1, 256)):
        plan = att.decode_plan(b, hkv, s, rep, dh)
        assert plan == att.decode_plan(b, hkv, s, rep, dh)
        ch = plan.chunk
        assert ch % att._TILE == 0 and ch <= att._MAX_CHUNK
        assert plan.n_chunks == -(-s // ch)
        assert plan.blocks == b * hkv * plan.n_chunks < 2 ** 31
        assert plan.counters == b * hkv
        parts = b * hkv * plan.n_chunks * rep if plan.n_chunks > 1 else 0
        assert (plan.part_o, plan.part_ml) == (parts * dh, parts * 2)
        edges = [0, 1, ch - 1, ch, ch + 1, s]
        for length in _SMOKE_LENGTHS + edges:
            seen = np.zeros(s, np.int32)
            used = max(1, -(-length // ch))    # blocks past it exit at once
            for c in range(plan.n_chunks):
                if c >= used:
                    continue
                c0, c1 = c * ch, min(length, (c + 1) * ch)
                assert c1 - c0 <= ch and (c0 < c1 or length == c == 0)
                for t0 in range(c0, c1, att._TILE):
                    seen[t0:min(c1, t0 + att._TILE)] += 1
                if page and c1 > c0:
                    assert (c1 - 1) // page < -(-length // page)
            assert (seen[:length] == 1).all() and not seen[length:].any()
    # a full batch stays within about 8 blocks per SM, a short S gets the
    # shortest chunk
    assert att.decode_plan(2, 8, 2048, 4, 128).chunk == att._TILE
    assert att.decode_plan(8, 8, 8192, 4, 128, sms=132).blocks <= 8 * 132


@pytest.mark.parametrize("s,page", [(8192, None), (600, 16), (8192, 128)])
def test_windowed_decode_plan_covers_the_window_once(s, page):
    """Under a sliding window the plan is sized from min(S, window), and
    chunks counted from the window's first key (as the kernel counts them)
    cover each key of ``[max(0, length - window), length)`` once, none
    before it: no block, and no table entry, lies wholly before the
    window."""
    b, hkv, rep, dh = 8, 8, 2, 256
    for w in (1, 63, 64, 65, 700, 4096, s + 1):
        plan = att.decode_plan(b, hkv, s, rep, dh, window=w)
        assert plan == att.decode_plan(b, hkv, min(s, w), rep, dh)
        ch = plan.chunk
        for length in sorted({0, 1, 17, w - 1, w, w + 1, ch + 1, s - 1, s}):
            if not 0 <= length <= s:
                continue
            ws = max(0, length - w)
            used = max(1, -(-(length - ws) // ch))
            assert used <= plan.n_chunks
            seen = np.zeros(s, np.int32)
            for c in range(used):
                c0, c1 = ws + c * ch, min(length, ws + (c + 1) * ch)
                assert c0 < c1 or length == c == 0
                seen[c0:c1] += 1
                if page and c1 > c0:
                    assert c0 // page >= ws // page
                    # the page ids a block loads fit the kernel's array
                    assert (c1 - 1) // page - c0 // page + 1 <= (
                        ch // page + 2)
            assert (seen[ws:length] == 1).all()
            assert not seen[:ws].any() and not seen[length:].any()
    # a Gemma-2 local layer (window 4096) at S = 8192 reads half the keys
    # of a global one, in chunks of half the length
    local = att.decode_plan(8, 8, 8192, 2, 256, window=4096)
    full = att.decode_plan(8, 8, 8192, 2, 256)
    assert local.chunk * local.n_chunks * 2 == full.chunk * full.n_chunks


@pytest.mark.parametrize("s", [600, 2048, 8192])
@pytest.mark.parametrize("h", [4, 16, 128])
def test_mla_decode_plan_covers_each_token_once(h, s):
    """The latent-attention plan, walked as the kernel walks it (blocks of
    ``heads`` heads exit at or past a slot's length, tiles of ``_TILE``
    tokens): each valid token of each head in exactly one block, a grid
    within CUDA's limits, the merge's weights within the ring, and grid,
    workspace and counters from static ints alone (no lengths); both paths'
    head splits (16 heads a block on the CUDA cores)."""
    b, dq, r = 8, 640, 512
    for path in ("tc", "cuda_core"):
        plan = mla.mla_decode_plan(b, h, s, dq, r, path=path)
        assert plan == mla.mla_decode_plan(b, h, s, dq, r, path=path)
        hb, ch = plan.heads, plan.chunk
        assert hb % mla._HT == 0 and hb <= mla._WIDE_HEADS
        assert path == "tc" or hb == mla._HT
        assert mla._tc_smem(dq, hb) <= mla._SMEM_MAX
        assert plan.groups == -(-h // hb)
        assert ch % mla._TILE == 0 and ch <= mla._MAX_CHUNK
        assert plan.n_chunks == -(-s // ch)
        assert plan.n_chunks * hb * 4 <= mla._ring_bytes(dq)
        assert plan.blocks == b * plan.groups * plan.n_chunks < 2 ** 31
        assert plan.counters == b * plan.groups
        parts = (b * plan.groups * plan.n_chunks * hb
                 if plan.n_chunks > 1 else 0)
        assert (plan.part_o, plan.part_ml) == (parts * r, parts * 2)
        for length in sorted({0, 1, 63, 64, 65, ch - 1, ch, ch + 1, s}):
            if length > s:
                continue
            seen = np.zeros((h, s), np.int32)
            used = max(1, -(-length // ch))    # blocks past it exit at once
            for grp in range(plan.groups):
                h0 = grp * hb
                for c in range(used):
                    c0, c1 = c * ch, min(length, (c + 1) * ch)
                    assert c1 - c0 <= ch and (c0 < c1 or length == c == 0)
                    for t0 in range(c0, c1, mla._TILE):
                        seen[h0:h0 + hb, t0:min(c1, t0 + mla._TILE)] += 1
            assert (seen[:, :length] == 1).all() and not seen[:, length:].any()
    # the tensor-core path reads each row once for up to 32 heads; a full
    # batch stays within two blocks per SM, one for 16-head tensor-core
    # blocks
    assert mla.mla_decode_plan(8, 128, 2048, dq, r).heads == 32
    assert mla.mla_decode_plan(8, 16, 2048, dq, r).heads == 16
    for hq, path, per_sm in ((16, "tc", 1), (128, "tc", 2),
                             (16, "cuda_core", 2), (128, "cuda_core", 2)):
        plan = mla.mla_decode_plan(8, hq, 8192, dq, r, sms=132, path=path)
        assert plan.chunk == mla._TILE or plan.blocks <= per_sm * 132
        assert plan.blocks > per_sm * 132 // 2


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
    """dequant_matmul and flash decode against their plain versions at
    small shapes; dequant_matmul at each tile's M, N and group edges, each
    call counted under the tile it should take (the inserts are
    ``test_fused_insert_matches_plain_on_card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _build.build()
    # M across both tensor-core tiles and their edges; N ragged (V2-Lite's
    # wqkv, 3648) and 4 (not a multiple of 16: the CUDA-core tile); groups
    # of 64 and 128; K = 192 in groups of 64, whose high half starts in the
    # middle of a group
    shapes = ((512, 768, 128), (2048, 3648, 64), (512, 4, 128), (192, 64, 64))
    for bits in (4, 8):
        for k, n, g in shapes:
            kp = k // 2 if bits == 4 else k
            codes = torch.randint(0, 256, (kp, n), generator=gen, device=dev,
                                  dtype=torch.int32)
            codes = codes.to(torch.uint8) if bits == 4 else (codes - 128).to(
                torch.int8)
            qt = QTensor(codes=codes, scales=torch.rand(
                (k // g, n), generator=gen, device=dev) * 0.1, bits=bits,
                group_size=g, shape=(k, n))
            for m in (1, 3, 8, 9, 16, 17, 64, 130, 512):
                # bf16 out (wqkv, w_gate_up in the forward) takes the
                # kernels' bf16 stores: after the split-K fix-up at decode M,
                # direct at prefill M
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                    tile = ("cuda_core" if dt == torch.float32 or n % 16
                            else "tc_decode" if m <= 16 else "tc_prefill")
                    for odt in (torch.float32, torch.bfloat16):
                        _build.reset_launches()
                        ref = dequant_matmul_reference(x, qt, odt).float()
                        got = dequant_matmul(x, qt, out_dtype=odt)
                        assert got.dtype == odt
                        assert _build.launches[f"dequant_matmul[{tile}]"] == 1
                        tol = (1e-4 if dt == odt == torch.float32 else 2e-2)
                        assert ((got.float() - ref).abs().max()
                                <= tol * ref.abs().max()), (bits, k, n, m, dt,
                                                            odt)
    # a layer of a stacked [L, ...] QTensor, by view
    stack = QTensor(codes=torch.randint(0, 256, (3, 256, 768), generator=gen,
                                        device=dev, dtype=torch.int32).to(
                                            torch.uint8),
                    scales=torch.rand((3, 4, 768), generator=gen,
                                      device=dev) * 0.1,
                    bits=4, group_size=128, shape=(512, 768))
    for m, tile in ((8, "tc_decode"), (64, "tc_prefill")):
        x = torch.randn((m, 512), generator=gen, device=dev).to(torch.bfloat16)
        ref = dequant_matmul_reference(x, stack.layer(2), torch.float32)
        _build.reset_launches()
        got = dequant_matmul(x, stack, 2, out_dtype=torch.float32)
        assert _build.launches[f"dequant_matmul[{tile}]"] == 1
        assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    # flash decode at rep 1, 2, 4, 8 and Dh 64, 96, 128, 256 over the
    # plan's chunk edges (S spans several chunks, the last one partial)
    s, l, b, h = 600, 2, 8, 2
    for d in (64, 96, 128, 256):
        cache = [torch.randint(-127, 128, (l, b, h, s, d), generator=gen,
                               device=dev, dtype=torch.int8),
                 torch.rand((l, b, h, s), generator=gen, device=dev) * 0.02,
                 torch.randint(-127, 128, (l, b, h, s, d), generator=gen,
                               device=dev, dtype=torch.int8),
                 torch.rand((l, b, h, s), generator=gen, device=dev) * 0.02]
        for rep in (1, 2, 4, 8):
            ch = att.decode_plan(b, h, s, rep, d).chunk
            ln = torch.tensor([0, 1, 17, ch - 1, ch, ch + 1, 257, s],
                              dtype=torch.int32, device=dev)
            _check_decode(gen, lambda q: flash_decode_int8(q, *cache, ln, 1),
                          lambda q: flash_decode_int8_reference(
                              q, *cache, ln, 1),
                          "flash_decode_int8", (b, h * rep, d))


def _check_decode(gen, kernel, plain, name, shape):
    """A decode-attention kernel against its plain version with f32 q (1e-4
    of max|ref|, and 1e-4 absolute) and bf16 q (1e-2): each call counted
    once under the path it should take, slot 0 (length 0) all zeros, and
    a second call bit-equal to the first."""
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn(shape, generator=gen, device=gen.device).to(qdt)
        _build.reset_launches()
        got = kernel(q)
        path = "tc" if qdt == torch.bfloat16 and shape[2] % 32 == 0 \
            else "cuda_core"
        assert _build.launches[f"{name}[{path}]"] == 1 == _build.launches[
            name], (name, shape, qdt)
        ref = plain(q).float()
        again = kernel(q)
        torch.cuda.synchronize()
        bound = tol * float(ref.abs().max())
        if qdt == torch.float32:
            bound = min(bound, 1e-4)
        err = float((got.float() - ref).abs().max())
        assert err <= bound, (name, shape, qdt, err, bound)
        assert not got[0].float().abs().max()
        assert torch.equal(got, again), (name, shape, qdt)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16, 128])
def test_paged_cuda_kernels_match_plain_on_card(page):
    """Paged flash decode (f32 and bf16 q, rep 1, 2, 4 and 8, Dh 64, 128
    and 256) against its plain version at the plan's chunk edges; a chunk
    spans several pages or part of one, a tile crosses pages of 8 and 16,
    and table entries past each slot's pages point at the scratch page 0
    (the paged insert is a case of
    ``test_fused_insert_matches_plain_on_card``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(page)
    _build.build()
    for d in (64, 128, 256):
        l, h, max_pages = 2, 2, -(-600 // page)
        cap = max_pages * page
        ch = att.decode_plan(9, h, cap, 8, d).chunk
        lengths = [0, 1, 17, ch - 1, ch, ch + 1, 257, 599, cap]
        b = len(lengths)
        n_pool = 1 + b * max_pages
        # each slot's pages, the one its next token goes to included
        used = [min(max_pages, n // page + 1) if n else 0 for n in lengths]
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
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for rep in (1, 2, 4, 8):
            _check_decode(gen, lambda q: paged_flash_decode_int8(
                q, *pool, tbl, ln, 1), lambda q: paged_attention_reference(
                    q, *pool, tbl, ln, 1), "paged_flash_decode_int8",
                (b, h * rep, d))


@pytest.mark.gpu
@pytest.mark.parametrize("page", [None, 16, 128])
def test_windowed_softcapped_decode_matches_plain_on_card(page):
    """Both GQA decode kernels with a sliding window and a logit softcap
    (50, under Gemma-2's scale of 1/16; and 0) against their plain
    versions: Dh 128 and 256, rep 1, 2, 4 and 8, f32 and bf16 q, windows
    at the 64-token tile's and the plan's chunk edges, longer than the
    context, and 0; contiguous and paged at pages 16 and 128 (table entries
    past each slot's pages on the scratch page 0). Each call one launch on
    its path, a rerun bit-equal (``_check_decode``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(page or 1)
    _build.build()
    l, h, s = 2, 2, 600
    for d in (128, 256):
        if page:
            max_pages = -(-s // page)
            cap = max_pages * page
            shape = lambda x: (l, 1 + 8 * max_pages, h, page) + x
        else:
            cap = s
            shape = lambda x: (l, 8, h, s) + x
        kv = [torch.randint(-127, 128, shape((d,)), generator=gen, device=dev,
                            dtype=torch.int8),
              torch.rand(shape(()), generator=gen, device=dev) * 0.05,
              torch.randint(-127, 128, shape((d,)), generator=gen, device=dev,
                            dtype=torch.int8),
              torch.rand(shape(()), generator=gen, device=dev) * 0.05]
        for w in (0, 1, 63, 64, 65, 257, 1000):
            ch = att.decode_plan(8, h, cap, 8, d, window=w).chunk
            lengths = [0, 1, 65, ch - 1, ch + 1, 300, 599, cap]
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            tbl = None
            if page:
                used = [min(max_pages, n // page + 1) if n else 0
                        for n in lengths]
                perm = torch.randperm(8 * max_pages, generator=gen,
                                      device=dev) + 1
                tbl = torch.zeros((8, max_pages), dtype=torch.int32,
                                  device=dev)
                for i, u in enumerate(used):
                    tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
            for cap_, scale in ((50.0, 1 / 16), (0.0, None)):
                opts = dict(softcap=cap_, scale=scale)
                for rep in (1, 2, 4, 8):
                    if page:
                        _check_decode(
                            gen, lambda q: paged_flash_decode_int8(
                                q, *kv, tbl, ln, 1, w, **opts),
                            lambda q: paged_attention_reference(
                                q, *kv, tbl, ln, 1, w, **opts),
                            "paged_flash_decode_int8", (8, h * rep, d))
                    else:
                        _check_decode(
                            gen, lambda q: flash_decode_int8(
                                q, *kv, ln, 1, w, **opts),
                            lambda q: flash_decode_int8_reference(
                                q, *kv, ln, 1, w, **opts),
                            "flash_decode_int8", (8, h * rep, d))


def _bits(t):
    """A float tensor's bits, for bit-equality (NaN, -0.0 included)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (layout, s0 or page) of the gpu test of the fused insert
_FUSED_LAYOUTS = [("contiguous", 0), ("contiguous", 64), ("paged", 8),
                  ("paged", 16), ("paged", 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,at", _FUSED_LAYOUTS)
def test_fused_insert_matches_plain_on_card(layout, at, dtype):
    """The fused RoPE + K/V quantize + insert kernel against its plain
    version (the unfused chain) on the card: every cache byte equal (codes
    and scales), the rotated q bit-equal; Dh 64, 128 and 256 at rep 1, 4
    and 8; q, k and v as strided views of one projection row, and again
    with q and k contiguous (as after Qwen3's QK-norm) and a yarn attention
    factor; a slot at capacity, a parked slot (paged: into the scratch page
    0, the only slot writing there), at s0 64 positions another shard owns.
    Each call counted once, under [fused]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(at + len(dtype))
    _build.build(("cache_insert",))
    l, hkv, s = 2, 2, 256
    paged = layout == "paged"
    lengths = [0, 1, 37, 127, 128, 200, s - 1, s + (0 if paged else at)]
    b = len(lengths)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    name = "paged_cache_insert_int8" if paged else "cache_insert_int8"
    if paged:
        max_pages = s // at
        n_pool = 1 + b * max_pages
        # each slot's pages, the one its next token goes to included
        used = [min(max_pages, n // at + 1) if n else 0 for n in lengths]
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
        for i, u in enumerate(used):
            tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
    for dh in (64, 128, 256):
        lead = (l, n_pool, hkv, at) if paged else (l, b, hkv, s)
        cache = [torch.randint(-127, 128, lead + (dh,), generator=gen,
                               device=dev, dtype=torch.int8),
                 torch.rand(lead, generator=gen, device=dev) * 0.02,
                 torch.randint(-127, 128, lead + (dh,), generator=gen,
                               device=dev, dtype=torch.int8),
                 torch.rand(lead, generator=gen, device=dev) * 0.02]
        freqs = 500000.0 ** (-torch.arange(dh // 2, device=dev,
                                           dtype=torch.float64) / (dh // 2))
        ang = ln.double()[:, None, None, None] * freqs
        cos, sin = ang.cos().float(), ang.sin().float()
        for rep in (1, 4, 8):
            hq = hkv * rep
            row = torch.randn((b, 1, (hq + 2 * hkv) * dh), generator=gen,
                              device=dev).to(dt)
            q = row[..., :hq * dh].view(b, 1, hq, dh)
            k = row[..., hq * dh:(hq + hkv) * dh].view(b, 1, hkv, dh)
            v = row[..., (hq + hkv) * dh:].view(b, 1, hkv, dh)
            for views, factor in ((True, None), (False, 1.2247)):
                if not views:
                    q, k = q.contiguous(), k.contiguous()
                plain = [t.clone() for t in cache]
                _build.reset_launches()
                if paged:
                    got = paged_cache_insert_int8_fused(
                        q, k, v, cos, sin, *cache, ln, 1, tbl,
                        attn_factor=factor)
                    ref = paged_cache_insert_int8_fused_reference(
                        q, k, v, cos, sin, *plain, ln, 1, tbl,
                        attn_factor=factor)
                else:
                    got = cache_insert_int8_fused(
                        q, k, v, cos, sin, *cache, ln, 1, at,
                        attn_factor=factor)
                    ref = cache_insert_int8_fused_reference(
                        q, k, v, cos, sin, *plain, ln, 1, at,
                        attn_factor=factor)
                torch.cuda.synchronize()
                what = (layout, at, dtype, dh, rep, views)
                assert _build.launches[name] == 1, what
                assert _build.launches[f"{name}[fused]"] == 1, what
                assert got.dtype == dt and got.shape == (b, hq, dh), what
                assert torch.equal(_bits(got), _bits(ref)), what
                for a, r in zip(cache, plain):
                    assert torch.equal(_bits(a), _bits(r)), what


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
    and int8, M at both tensor-core tiles' sizes and edges, bf16 and f32
    out, without a hot list and with hot lists of none, some and all of the
    slots. The output buffer is handed out NaN-filled, and the tail slots' x
    rows are NaN in psum: the tail must come out exactly zero (concat) or
    not at all (psum). Then the last expert of the last layer of a stack
    holding more than 2^32 bytes of codes (64-bit offsets), through the
    CUDA-core and the decode tile, where the card has the memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    _build.build()
    e, nl, k, n = 4, 3, 512, 768
    # hot lists of none, some and all of the slots (ids past n_hot repeat)
    hots = [torch.tensor(h, dtype=torch.int32, device=dev)
            for h in ([0, 0, 0, 0, 0], [2, 3, 1, 1, 1], [4, 2, 0, 3, 1])]
    for bits in (4, 8):
        qt = _rand_stack(gen, dev, e * nl, k, n, bits)
        for m in (1, 5, 16, 17, 130):
            tile = "tc_decode" if m <= 16 else "tc_prefill"
            for mode in ("concat", "psum"):
                for h in [None] + hots:
                    n_hot = e if h is None else int(h[0])
                    shape = (m, k) if mode == "concat" else (e, m, k)
                    x = torch.randn(shape, generator=gen, device=dev)
                    if mode == "psum":
                        x[n_hot:] = float("nan")
                    for odt in (torch.float32, torch.bfloat16):
                        xb = x.to(torch.bfloat16)
                        kw = dict(n_experts=e, stride=nl, mode=mode,
                                  out_dtype=odt, hot=h)
                        ref = dequant_matmul_moe_reference(
                            xb, qt, 2, **kw).float()
                        width = e * n if mode == "concat" else n
                        ptr = _nan_block((m, width), odt, dev)
                        _build.reset_launches()
                        got = dequant_matmul_moe(xb, qt, 2, **kw)
                        torch.cuda.synchronize()
                        assert _build.launches[
                            f"dequant_matmul_moe[{tile}]"] == 1
                        assert got.data_ptr() == ptr and got.dtype == odt
                        assert torch.isfinite(got).all()
                        if mode == "concat":
                            assert not got.view(m, e, n)[:, n_hot:].any()
                        err = (got.float() - ref).abs().max()
                        assert err <= 2e-2 * max(float(ref.abs().max()),
                                                 1e-30), (
                            bits, m, mode, n_hot, odt)
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
    w = qt.layer(7).dequantize(torch.float32)
    # f32 x through the CUDA-core tile, against the plain version; bf16 x
    # through the decode tile, against the f32 product of the same bf16 x
    # with the f32 weights (the tile multiplies exact bf16 codes and x and
    # scales the f32 partial sums: the plain version's bf16 rounding of
    # each weight is not its rounding)
    for dt, tile in ((torch.float32, "cuda_core"), (torch.bfloat16,
                                                     "tc_decode")):
        x = torch.randn((4, 1, k), generator=gen, device=dev).to(dt)
        ref = (dequant_matmul_reference(x[0], qt.layer(7), torch.float32)
               if dt == torch.float32 else x[0].float() @ w)
        for mode, xs in (("concat", x[0]), ("psum", x)):
            _build.reset_launches()
            got = dequant_matmul_moe(xs, qt, 1, n_experts=4, stride=2,
                                     mode=mode, out_dtype=torch.float32,
                                     hot=last)
            torch.cuda.synchronize()
            assert _build.launches[f"dequant_matmul_moe[{tile}]"] == 1
            got = got[:, :n] if mode == "concat" else got
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), (
                mode, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dq", [128, 576, 640])
@pytest.mark.parametrize("h", [4, 16, 32, 128])
def test_mla_cuda_kernels_match_plain_on_card(h, dq):
    """MLA flash decode against its plain version at test-tiny-mla's rows
    (Dq 128, r 64) and DeepSeek's (Dq 576 unpadded and 640, r 512), 4
    (zero-padded row tile), 16 (DeepSeek-V2-Lite), 32 and
    128 heads (DeepSeek-V3): each heads-per-block instance of the tensor-core
    path. f32 q on the CUDA-core path within 1e-4 of max|ref|, bf16 q on the
    tensor-core path within 1e-2; each call counted under its path, a second
    call bit-equal, the empty slot all zeros. S 600 spans several tiles and
    chunks, the last one partial; S 4096 gives each block several tiles
    through the copy ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(h + dq)
    _build.build()
    r = 64 if dq == 128 else 512
    l = 3
    for s in (600, 4096):
        lengths = [0, 1, 65, 300, s - 1, s]
        b = len(lengths)
        kc = torch.randint(-127, 128, (l, b, 1, s, dq), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.int8)
        ks = torch.rand((l, b, 1, s), generator=gen, device=dev) * 0.02
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for qdt, tol, path in ((torch.float32, 1e-4, "cuda_core"),
                               (torch.bfloat16, 1e-2, "tc")):
            q = torch.randn((b, h, dq), generator=gen, device=dev).to(qdt)
            _build.reset_launches()
            got = mla_flash_decode_int8(q, kc, ks, ln, 1, r=r, scale=0.07)
            assert _build.launches["mla_flash_decode_int8"] == 1
            assert _build.launches[f"mla_flash_decode_int8[{path}]"] == 1
            again = mla_flash_decode_int8(q, kc, ks, ln, 1, r=r, scale=0.07)
            ref = mla_flash_decode_int8_reference(q, kc, ks, ln, 1, r=r,
                                                  scale=0.07)
            torch.cuda.synchronize()
            assert got.dtype == qdt and got.shape == (b, h, r)
            assert torch.isfinite(got).all()
            err = (got.float() - ref.float()).abs().max()
            assert err <= tol * ref.float().abs().max(), (s, qdt, float(err))
            assert torch.equal(got, again), (s, qdt)
            assert not got[0].float().abs().max()


def latent_agrees(cache, plain, rows: int) -> int:
    """The fused MLA insert's latent cache against its plain chain's, where
    ``rows`` rows were written: byte-equal, or (the RMSNorm's sum of
    squares is taken in another order than ATen's) every scale within
    2**-7 relative, every code within 1, and at most 1e-3 of the written
    codes different. Returns the count of codes that differ."""
    d = (cache[0].int() - plain[0].int()).abs()
    n = int((d > 0).sum())
    assert int(d.max()) <= 1 and n <= 1e-3 * rows * d.shape[-1], n
    assert ((cache[1] - plain[1]).abs() <= 2.0 ** -7 * plain[1].abs()).all()
    return n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,dq", [(16, 640), (128, 640), (4, 128)])
def test_mla_fused_insert_matches_plain_on_card(h, dq, dtype):
    """The fused MLA latent kernel (RMSNorm of c, interleaved RoPE of k_pe
    and q_pe, the latent row quantized and inserted, q_eff written) against
    its plain version (the unfused chain) on the card, at DeepSeek's widths
    (r 512, dr 64, Dq 640; H 16 as V2-Lite, 128 as V3) and test-tiny-mla's
    (r 64, dr 16, Dq 128, H 4): q_eff bit-equal, the latent cache
    byte-equal or within :func:`latent_agrees`; ckv and q_pe views of one
    down-projection row (V2-Lite) and q_pe a view of a separate w_q_b row
    with yarn's attention factor (V3), q_abs as the einsum leaves it; s0 0
    and 64, slots at 0, S - 1, S and past it (dropped at capacity or before
    s0). Each call counted once, under [fused]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(h + dq + len(dtype))
    _build.build(("cache_insert",))
    cfg = PRESETS["deepseek-v2-lite" if dq == 640 else "test-tiny-mla"]
    r, dr, dn = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    l, s = 3, 256
    lengths = [0, 1, 65, 200, s - 1, s, s + 63, s + 64]
    b = len(lengths)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = _rope_tables(ln[:, None], cfg.rope_theta, dr, cfg)
    w = 1.0 + 0.1 * torch.randn(r, generator=gen, device=dev)
    w_uk = torch.randn((h, dn, r), generator=gen, device=dev).to(dt) * 0.1
    for s0 in (0, 64):
        for split, factor in (("akv", None), ("q_b", 1.0857)):
            qw = h * (dn + dr)
            akv = torch.randn((b, 1, (qw if split == "akv" else 1536) + r
                               + dr), generator=gen, device=dev).to(dt)
            src = (akv[..., :qw] if split == "akv" else torch.randn(
                (b, 1, qw), generator=gen, device=dev).to(dt))
            qh = src.view(b, 1, h, dn + dr)
            ckv, q_pe = akv[..., -(r + dr):], qh[..., dn:]
            q_abs = torch.einsum("bthn,hnr->bthr", qh[..., :dn], w_uk)
            cache = [torch.randint(-127, 128, (l, b, 1, s, dq), generator=gen,
                                   device=dev, dtype=torch.int8),
                     torch.rand((l, b, 1, s), generator=gen, device=dev)]
            plain = [t.clone() for t in cache]
            opts = dict(eps=cfg.norm_eps, attn_factor=factor,
                        interleaved=True)
            _build.reset_launches()
            got = mla_cache_insert_int8_fused(ckv, q_pe, q_abs, w, cos, sin,
                                              *cache, ln, 1, s0, **opts)
            ref = mla_cache_insert_int8_fused_reference(
                ckv, q_pe, q_abs, w, cos, sin, *plain, ln, 1, s0, **opts)
            torch.cuda.synchronize()
            what = (h, dq, dtype, s0, split)
            assert _build.launches["mla_cache_insert_int8"] == 1, what
            assert _build.launches["mla_cache_insert_int8[fused]"] == 1, what
            assert got.dtype == dt and got.shape == (b, h, dq), what
            assert torch.equal(_bits(got), _bits(ref)), what
            latent_agrees(cache, plain,
                          sum(0 <= n - s0 < s for n in lengths))


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
