"""The int4 KV cache (``kv_bits=4``: codes packed two to a byte across head
pairs) and the MLA latent cache at ``kv_bits=16``, the port against the JAX
package (CPU).

* ``quantize_kv(x, 4)`` and ``dequant_kv`` against the JAX functions:
  codes and scales equal, but for a handful of codes one step off at a
  rounding tie (``tests/test_torch_llama.py``'s rule); the unpacking
  equal along both head axes.
* The int4 cache's decode plan: packed-head blocks, ``2 rep`` rows of
  partials, every token in one block.
* The plain versions of both GQA decode kernels over the int4 cache,
  contiguous, stacked and paged, with sliding windows of 0 and 16
  and a tanh softcap of 30 under a ``query_pre_attn_scalar`` scale,
  against the JAX XLA attention over the same cache (paged: over the JAX
  ``paged_gather`` of the pool) within 2e-5, the tolerance of the JAX
  kv4 kernel tests; a slot of length 0 gives zeros.
* The fused inserts' plain versions at ``kv_bits=4``, contiguous and
  paged, against the JAX chain (``_rope``, ``quantize_kv(.., 4)``, the
  forward's cache insert): V scales equal, K scales within 1e-5
  (RoPE tables of two libraries), codes under the tie rule, every entry
  not written untouched.
* ``forward`` on test-tiny at ``kv_bits=4`` (a 12-token prefill and 4
  decode steps at B=2), contiguous and paged, against JAX ``forward`` over
  its contiguous cache (the paged pool's codes gathered per slot): the
  port's plain mode and its kernel mode, 1e-4 of max|logit|, 1e-3 from a
  slot's first code that differs by a tie; decode in kernel mode takes the
  fused insert at ``kv_bits=4`` and the flash decode over the uint8 cache.
* The contiguous, paged (preempting) and prefix-caching ``Engine`` at
  ``kv_bits=4``: greedy streams equal the JAX contiguous engine's (which
  its paged and prefix-caching engines equal, ``tests/test_paged.py``).
* ``eval --kv-bits 4 --device cpu`` on a port-written test-tiny checkpoint
  within 1e-4 of JAX ``perplexity`` at ``kv_bits=4``; ``generate
  --kv-bits 4`` as the engine gives it.
* test-tiny-mla at ``kv_bits=16`` against JAX ``forward``, 1e-4.

The ``gpu``-marked tests hold the kv4 CUDA kernels against their plain
versions on the card (skipped here; a machine with a card and without JAX
runs them with ``python -m pytest --noconftest -m gpu
tests/test_torch_kv4.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from quant_tpu.checkpoint.format import _flatten_params
    from quant_tpu.checkpoint.format import load_checkpoint as j_load
    from quant_tpu.engine import Engine as JEngine
    from quant_tpu.engine import Request as JRequest
    from quant_tpu.eval import perplexity as j_perplexity
    from quant_tpu.kernels.paged_attention import paged_gather as j_gather
    from quant_tpu.models import PRESETS as JPRESETS
    from quant_tpu.models import llama as jllama
    from quant_tpu.models.config import ModelConfig as JConfig
except ModuleNotFoundError:   # only the gpu-marked tests can run there
    pass

from quant_tpu_torch.kernels import _build
from quant_tpu_torch.kernels import attention as att
from quant_tpu_torch.kernels.attention import (flash_decode_int8,
                                               flash_decode_int8_reference)
from quant_tpu_torch.kernels.cache_insert import (
    cache_insert_int8_fused, cache_insert_int8_fused_reference,
    paged_cache_insert_int8_fused, paged_cache_insert_int8_fused_reference)
from quant_tpu_torch.kernels.paged_attention import (
    paged_attention_reference, paged_flash_decode_int8)
from quant_tpu_torch.kernels.rope_kv import quantize_kv

try:
    from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
    from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
    from quant_tpu_torch.cli import main as t_cli
    from quant_tpu_torch.engine import Engine as TEngine
    from quant_tpu_torch.engine import Request as TRequest
    from quant_tpu_torch.models import PRESETS as TPRESETS
    from quant_tpu_torch.models import llama as tllama
    from quant_tpu_torch.models.config import ModelConfig as TConfig
    from quant_tpu_torch.models.llama import _rope_tables
    from quant_tpu_torch.models.transfer import params_from_flat
except ModuleNotFoundError:
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nibbles(codes) -> np.ndarray:
    """uint8 head-pair codes -> their int32 nibbles, the low (real head
    2j) and the high (2j + 1) stacked on a new last axis."""
    c = np.asarray(codes).astype(np.int32)
    return np.stack([c & 15, c >> 4], axis=-1)


def _assert_codes_close(got, ref, what):
    """The tie rule: codes equal but for a handful (at most 1e-3 of them,
    and at most 4), each one step off."""
    d = np.abs(_nibbles(got) - _nibbles(ref))
    assert d.max() <= 1, what
    assert np.sum(d > 0) <= max(4, 1e-3 * d.size), (what, np.sum(d > 0))


# ── quantization ─────────────────────────────────────────────────────────


@pytest.mark.parametrize("h", [2, 8])
def test_quantize_kv_matches_jax(h):
    rng = np.random.default_rng(h)
    x = (rng.standard_normal((3, 5, h, 64))
         * rng.uniform(0.1, 4.0, (3, 5, h, 1))).astype(np.float32)
    x[0, 0, 1] = 0.0                          # absmax 0: scale 1, codes 8
    jc, js = (np.asarray(a) for a in jllama.quantize_kv(jnp.asarray(x), 4))
    tc, ts = quantize_kv(torch.from_numpy(x), 4)
    assert tc.dtype == torch.uint8 and tuple(tc.shape) == (3, 5, h // 2, 64)
    assert jc.shape == tuple(tc.shape) and ts.dtype == torch.float32
    _assert_codes_close(tc.numpy(), jc, h)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts[0, 0, 1] == 1.0 and np.all(_nibbles(tc[0, 0, 0])[..., 1] == 8)
    # head pairs: packed head j holds real head 2j low, 2j + 1 high
    low = torch.round(torch.from_numpy(x[..., 0::2, :]) / ts[..., 0::2, None])
    assert np.mean((tc.numpy() & 15) == low.numpy() + 8) > 0.99
    # unpacking, per-token [B, T, H/2, D] and cache [B, H/2, T, D] axes
    for codes, axis in ((jc.copy(), -2), (np.ascontiguousarray(
            jc.transpose(0, 2, 1, 3)), -3)):
        np.testing.assert_array_equal(
            tllama.dequant_kv(torch.from_numpy(np.array(codes)), 4,
                              axis).numpy(),
            np.asarray(jllama.dequant_kv(jnp.asarray(codes), 4, axis)))


# ── the decode kernels' plain versions ───────────────────────────────────

_S, _HQ, _HKV, _DH, _PAGE = 256, 8, 4, 64, 16
_LENGTHS = np.asarray([250, 37, 0], np.int32)
_QPAS = 32.0


def _kv4_cache(rng, layers: int):
    """int4 caches ``[L, B, Hkv/2, S, Dh]`` / ``[L, B, Hkv, S]`` quantized as
    the model writes them (JAX ``quantize_kv``)."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((layers, 3, _S, _HKV, _DH)).astype(np.float32)
        c, s = (np.asarray(a) for a in jllama.quantize_kv(jnp.asarray(x), 4))
        out += [np.ascontiguousarray(c.transpose(0, 1, 3, 2, 4)),
                np.ascontiguousarray(s.transpose(0, 1, 3, 2))]
    return out


def _to_pool(a, tbl, page):
    """Slot rows ``[L, B, H, S, ..]`` into a pool ``[L, P, H, page, ..]``
    under ``tbl`` (page 0 left as zeros)."""
    pool = np.zeros((a.shape[0], 1 + tbl.size, a.shape[2], page)
                    + a.shape[4:], a.dtype)
    for b in range(a.shape[1]):
        for j in range(tbl.shape[1]):
            pool[:, tbl[b, j]] = a[:, b, :, j * page:(j + 1) * page]
    return pool


def _att_cfg(softcap: float):
    return JConfig(vocab_size=512, dim=512, n_layers=1, n_heads=_HQ,
                   n_kv_heads=_HKV, head_dim=_DH, intermediate=512,
                   kv_bits=4, attn_softcap=softcap,
                   query_pre_attn_scalar=_QPAS, kernel_mode="xla",
                   dtype="float32")


@pytest.mark.parametrize("layout", ["contiguous", "stacked", "paged"])
def test_decode_references_match_jax(layout):
    rng = np.random.default_rng(11)
    layers = 1 if layout == "contiguous" else 2
    layer = layers - 1
    q = (4.0 * rng.standard_normal((3, _HQ, _DH))).astype(np.float32)
    kv = _kv4_cache(rng, layers)
    tbl = rng.permutation(np.arange(1, 1 + 3 * _S // _PAGE)).reshape(
        3, -1).astype(np.int32)
    if layout == "paged":
        kv = [_to_pool(a, tbl, _PAGE) for a in kv]
        jkv = [j_gather(jnp.asarray(a), jnp.asarray(tbl), layer) for a in kv]
    else:
        if layout == "contiguous":
            kv = [a[0] for a in kv]
        jkv = [jnp.asarray(a if layout == "contiguous" else a[layer])
               for a in kv]
    tkv = [torch.from_numpy(a) for a in kv]
    tq, ln = torch.from_numpy(q), torch.from_numpy(_LENGTHS)
    lay = None if layout == "contiguous" else layer
    live = _LENGTHS > 0
    for softcap in (0.0, 30.0):
        cfg = _att_cfg(softcap)
        for w in (0, 16):
            ref = np.asarray(jllama.attention(
                jnp.asarray(q)[:, None], *jkv,
                jnp.asarray(_LENGTHS - 1)[:, None], jnp.asarray(_LENGTHS),
                cfg, window=jnp.int32(w)))[:, 0]
            opts = dict(softcap=softcap, scale=_QPAS ** -0.5)
            if layout == "paged":
                got = paged_attention_reference(
                    tq, *tkv, torch.from_numpy(tbl), ln, layer, w, **opts)
                call = paged_flash_decode_int8(
                    tq, *tkv, torch.from_numpy(tbl), ln, layer, w, **opts)
            else:
                got = flash_decode_int8_reference(tq, *tkv, ln, lay, w,
                                                  **opts)
                call = flash_decode_int8(tq, *tkv, ln, lay, w, **opts)
            assert torch.equal(got, call)        # the CPU dispatch
            np.testing.assert_allclose(got.numpy()[live], ref[live],
                                       rtol=2e-5, atol=2e-5)
            assert not got[~torch.from_numpy(live)].abs().max()


@pytest.mark.parametrize("s", [2048, 8192])
def test_kv4_decode_plan(s):
    """The int4 cache's plan: blocks of packed heads (``Hkv/2`` per slot),
    a workspace of ``2 rep`` rows a (slot, packed head, chunk), the chunk
    the shortest keeping the call within 32 query rows of partials per SM;
    every token of every length in exactly one block, walked as the kernel
    walks it."""
    for b, hkv, rep, dh in ((8, 8, 4, 128), (8, 4, 8, 128), (3, 2, 1, 64),
                            (8, 8, 2, 256)):
        plan = att.decode_plan(b, hkv, s, rep, dh, kv4=True)
        ch, hc = plan.chunk, hkv // 2
        assert ch % att._TILE == 0 and plan.n_chunks == -(-s // ch)
        assert plan.blocks == b * hc * plan.n_chunks
        assert plan.counters == b * hc
        parts = b * hc * plan.n_chunks * 2 * rep if plan.n_chunks > 1 else 0
        assert (plan.part_o, plan.part_ml) == (parts * dh, parts * 2)
        assert (ch == att._TILE
                or b * hc * 2 * rep * -(-s // (ch // 2)) > 32 * 132)
        for length in (0, 1, ch - 1, ch, ch + 1, s // 3, s):
            used = max(1, -(-length // ch))
            seen = np.zeros(s, np.int32)
            for c in range(min(used, plan.n_chunks)):
                seen[c * ch:min(length, (c + 1) * ch)] += 1
            assert (seen[:length] == 1).all() and not seen[length:].any()
    # Llama-3-8B's B=8 plans: the int8 plan's chunks, half its blocks
    for s_, chunk in ((2048, 128), (8192, 512)):
        four = att.decode_plan(8, 8, s_, 4, 128, kv4=True)
        eight = att.decode_plan(8, 8, s_, 4, 128)
        assert four.chunk == eight.chunk == chunk
        assert 2 * four.blocks == eight.blocks


# ── the fused inserts' plain versions ────────────────────────────────────

_THETA = 500000.0
_IPAGE, _ICAP = 8, 32


def _insert_inputs(layout: str):
    rng = np.random.default_rng(5)
    b, hq, hkv, dh = 4, 8, 4, 64
    row = (2.0 * rng.standard_normal((b, 1, (hq + 2 * hkv) * dh))).astype(
        np.float32)
    lengths = np.asarray([19, _ICAP, 0, 5], np.int32)   # one at capacity
    lead = ((2, 1 + b * _ICAP // _IPAGE, hkv, _IPAGE) if layout == "paged"
            else (2, b, hkv, _ICAP))
    code_lead = lead[:2] + (hkv // 2,) + lead[3:]
    cache = []
    for _ in range(2):
        cache += [rng.integers(0, 256, code_lead + (dh,)).astype(np.uint8),
                  rng.random(lead).astype(np.float32)]
    tbl = None
    if layout == "paged":
        tbl = rng.permutation(np.arange(1, 1 + b * _ICAP // _IPAGE)).reshape(
            b, -1).astype(np.int32)
    return row, cache, lengths, tbl


def _split(row):
    hq, hkv, dh = 8, 4, 64
    b = row.shape[0]
    return (row[..., :hq * dh].reshape(b, 1, hq, dh),
            row[..., hq * dh:(hq + hkv) * dh].reshape(b, 1, hkv, dh),
            row[..., (hq + hkv) * dh:].reshape(b, 1, hkv, dh))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_fused_insert_references_match_jax(layout):
    row, cache, lengths, tbl = _insert_inputs(layout)
    # the JAX chain, eagerly (under jit XLA may divide by another rounding
    # of the scale), then the JAX forward's cache insert
    jq, jk, jv = _split(jnp.asarray(row))
    pos, jln = jnp.asarray(lengths[:, None]), jnp.asarray(lengths)
    jq = jllama._rope(jq, pos, _THETA)
    ref = []
    for (cc, cs), (codes, scale) in zip(
            ((cache[0], cache[1]), (cache[2], cache[3])),
            (jllama.quantize_kv(jllama._rope(jk, pos, _THETA), 4),
             jllama.quantize_kv(jv, 4))):
        cc, cs = jnp.asarray(cc), jnp.asarray(cs)
        ref += ([np.asarray(a) for a in jllama._cache_insert_at_layer(
            cc, cs, codes, scale, jln, 1)] if tbl is None else
                [np.asarray(a) for a in jllama._paged_insert_at_layer(
                    cc, cs, codes, scale, jln, 1, jnp.asarray(tbl))])
    trow = torch.from_numpy(row)
    q, k, v = _split(trow)
    assert not (q.is_contiguous() or k.is_contiguous())
    cos, sin = _rope_tables(torch.from_numpy(lengths)[:, None], _THETA, 64)
    ln = torch.from_numpy(lengths)
    got_c = [torch.from_numpy(a.copy()) for a in cache]
    plain_c = [torch.from_numpy(a.copy()) for a in cache]
    if tbl is None:
        got = cache_insert_int8_fused(q, k, v, cos, sin, *got_c, ln, 1,
                                      kv_bits=4)
        plain = cache_insert_int8_fused_reference(q, k, v, cos, sin,
                                                  *plain_c, ln, 1, kv_bits=4)
    else:
        t = torch.from_numpy(tbl)
        got = paged_cache_insert_int8_fused(q, k, v, cos, sin, *got_c, ln, 1,
                                            t, kv_bits=4)
        plain = paged_cache_insert_int8_fused_reference(
            q, k, v, cos, sin, *plain_c, ln, 1, t, kv_bits=4)
    assert torch.equal(got, plain)               # the CPU dispatch
    assert all(torch.equal(a, b) for a, b in zip(got_c, plain_c))
    assert np.max(np.abs(got.numpy() - np.asarray(jq[:, 0]))) <= 1e-5
    # the rows the step writes (layer 1): [L, B or P, H, S or page]
    rows = np.zeros(cache[1].shape, bool)
    for b, n in enumerate(lengths):
        if tbl is None and n < _ICAP:
            rows[1, b, :, n] = True
        elif tbl is not None and n < _ICAP:
            rows[1, tbl[b, n // _IPAGE], :, n % _IPAGE] = True
    assert rows.sum() == 4 * (len(lengths) - 1)   # one slot drops its row
    crow = rows[:, :, ::2]                        # the packed code rows
    for i in (0, 2):
        t_c = got_c[i].numpy()
        np.testing.assert_array_equal(t_c[~crow], cache[i][~crow])
        np.testing.assert_array_equal(ref[i][~crow], cache[i][~crow])
        _assert_codes_close(t_c[crow], ref[i][crow], (layout, i))
    np.testing.assert_allclose(got_c[1].numpy(), ref[1], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got_c[3].numpy(), ref[3])


# ── forward and the engines ──────────────────────────────────────────────

_B, _MAX_SEQ, _FPAGE = 2, 32, 8
_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",)) if (
    "jllama" in globals()) else None


def _tiny(**kw):
    jc = dataclasses.replace(JPRESETS["test-tiny"], **{
        "kv_bits": 4, "dtype": "float32", "kernel_mode": "xla", **kw})
    return jc, TConfig(**dataclasses.asdict(jc))


def _table():
    n = _MAX_SEQ // _FPAGE
    return np.random.default_rng(5).permutation(
        np.arange(1, 1 + _B * n)).reshape(_B, n).astype(np.int32)


def _slot_codes(codes, paged: bool):
    """Codes as ``[L, B, Hc, S, D]`` (a pool gathered through the table)."""
    codes = np.asarray(codes)
    if not paged:
        return codes
    g = np.moveaxis(codes[:, _table()], 3, 2)     # [L, B, Hc, n, page, D]
    return g.reshape(*g.shape[:3], -1, g.shape[-1])


def _forward_run(fwd, params, cfg, cache, toks, to_np):
    outs = []
    for x in toks:
        lg, cache = fwd(params, x, cache, cfg)
        outs.append(to_np(lg))
    return outs, cache


@pytest.fixture(scope="module")
def jax_tiny():
    """(flat params, tokens, logits per call, K and V codes) of JAX
    ``forward`` over the contiguous cache (its paged pool gives the same,
    ``tests/test_paged.py``)."""
    jc, _ = _tiny()
    jp = jllama.init_params(jc, seed=3)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, jc.vocab_size, (_B, 12)).astype(np.int32)] + [
        rng.integers(0, jc.vocab_size, (_B, 1)).astype(np.int32)
        for _ in range(4)]
    outs, cache = _forward_run(
        lambda p, x, c, cfg: _jit_forward(p, jnp.asarray(x), c, cfg=cfg),
        jp, jc, jllama.init_cache(jc, _B, _MAX_SEQ), toks,
        lambda lg: np.asarray(lg, np.float32))
    return (jax.tree.map(np.asarray, _flatten_params(jp)), toks, outs,
            [np.asarray(cache.k_codes), np.asarray(cache.v_codes)])


@pytest.mark.parametrize("paged", [False, True])
def test_forward_matches_jax(jax_tiny, paged):
    flat, toks, ref, j_codes = jax_tiny
    _, tc = _tiny()
    tparams = params_from_flat(flat, tc, "cpu")
    for mode in ("xla", "auto"):
        c = dataclasses.replace(tc, kernel_mode=mode)
        if paged:
            cache = tllama.init_paged_cache(c, _B, _MAX_SEQ,
                                            1 + _table().size, _FPAGE,
                                            device="cpu")
            cache.page_tbl.copy_(torch.from_numpy(_table()))
        else:
            cache = tllama.init_cache(c, _B, _MAX_SEQ, "cpu")
        assert cache.k_codes.dtype == torch.uint8
        got, cache = _forward_run(
            lambda p, x, cc, cfg: tllama.forward(p, torch.from_numpy(x), cc,
                                                 cfg, device="cpu"),
            tparams, c, cache, toks, lambda lg: lg.numpy())
        # [B, S]: positions from a slot's first code that differs (a tie)
        diff = np.zeros((_B, _MAX_SEQ), bool)
        for jcodes, tcodes in zip(j_codes, (cache.k_codes, cache.v_codes)):
            t = _slot_codes(tcodes.numpy(), paged)
            _assert_codes_close(t, jcodes, (paged, mode))
            diff |= (t != jcodes).any(axis=(0, 2, 4))
        tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref, got):
            assert r.shape == g.shape and np.isfinite(g).all()
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
            assert np.all(err <= tol), (paged, mode, err)
            pos0 += r.shape[1]


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_mode_takes_the_kv4_pair(monkeypatch, paged):
    """Decode in kernel mode hands the fused insert ``kv_bits=4`` and the
    flash decode the uint8 head-pair cache, once per layer; prefill takes
    neither."""
    _, tc = _tiny(kernel_mode="auto")
    params = tllama.init_params(tc, seed=0, device="cpu")
    if paged:
        cache = tllama.init_paged_cache(tc, 2, 32, 9, 8, device="cpu")
        cache.page_tbl.copy_(torch.arange(1, 9, dtype=torch.int32).reshape(
            2, 4))
        names = ("paged_cache_insert_int8_fused", "paged_flash_decode_int8")
    else:
        cache = tllama.init_cache(tc, 2, 32, "cpu")
        names = ("cache_insert_int8_fused", "flash_decode_int8")
    calls = []
    for name in names:
        def spy(*a, _n=name, _f=getattr(tllama, name), **kw):
            calls.append((_n, kw.get("kv_bits") if _n == names[0]
                          else a[1].dtype))
            return _f(*a, **kw)
        monkeypatch.setattr(tllama, name, spy)
    _, cache = tllama.forward(params, [[1, 2, 3], [4, 5, 6]], cache, tc,
                              device="cpu")
    assert not calls
    _, cache = tllama.forward(params, [[7], [8]], cache, tc, device="cpu")
    assert calls == [(names[0], 4), (names[1], torch.uint8)] * tc.n_layers


def _engine_prompts():
    """Two prompts sharing two 8-token blocks, and a third of 21 tokens."""
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(3, 256, 16)]
    return [shared + [int(t) for t in rng.integers(3, 256, 6)],
            shared + [int(t) for t in rng.integers(3, 256, 3)],
            [int(t) for t in rng.integers(3, 256, 21)]]


def _drive(eng, make_req):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_engine_prompts())]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


_ENGINES = {"contiguous": dict(max_slots=2, max_seq=48, eos_id=-1),
            "paged": dict(max_slots=2, max_seq=48, eos_id=-1, paged=True,
                          page_size=8, n_pages=7),
            "paged-prefix": dict(max_slots=2, max_seq=48, eos_id=-1,
                                 paged=True, page_size=8, n_pages=9,
                                 prefix_cache=True)}


@pytest.fixture(scope="module")
def jax_engine():
    """(flat params, greedy streams of the JAX contiguous engine at
    ``kv_bits=4``), which its paged and prefix-caching engines equal
    (``tests/test_paged.py``)."""
    jc, _ = _tiny()
    jparams = jllama.init_params(jc, seed=4)
    want = _drive(JEngine(jparams, jc, **_ENGINES["contiguous"]), JRequest)
    return jax.tree.map(np.asarray, _flatten_params(jparams)), want


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_engine_matches_jax(jax_engine, kind):
    """Greedy streams of three requests (22, 19 and 21 prompt tokens, the
    first two sharing two blocks; 6 new, two slots) equal the JAX
    engine's at ``kv_bits=4``; the 7-page pool preempts, the prefix cache
    reuses the shared blocks."""
    flat, want = jax_engine
    _, tc = _tiny(kernel_mode="auto")
    eng = TEngine(params_from_flat(flat, tc, "cpu"), tc, device="cpu",
                  **_ENGINES[kind])
    assert eng.cache.k_codes.dtype == torch.uint8
    preempted = []
    inner = eng._preempt_newest

    def counted(*a):
        preempted.append(1)
        return inner(*a)
    eng._preempt_newest = counted
    assert _drive(eng, TRequest) == want
    assert all(len(o) == 6 for o in want)
    if kind == "paged":
        assert preempted
    if kind == "paged-prefix":
        assert eng.stats["prefix_hit_tokens"] > 0


def test_cli_eval_and_generate_kv4(tmp_path, capsys):
    """``eval --kv-bits 4`` of a port-written checkpoint (int8 KV in its
    config) against JAX ``perplexity`` at ``kv_bits=4`` on the JAX loader's
    params: NLL within 1e-4; ``generate --kv-bits 4`` gives the kv4
    engine's greedy streams."""
    _, tc = _tiny()
    tc8 = dataclasses.replace(tc, kv_bits=8)
    t_save(tmp_path / "ck", tllama.init_params(tc8, seed=0, device="cpu"),
           tc8)
    text = tmp_path / "text.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 4)
    assert t_cli(["eval", str(tmp_path / "ck"), "--text", str(text),
                  "--window", "32", "--limit-windows", "2", "--kv-bits", "4",
                  "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.splitlines()[-1])
    jparams, jcfg = j_load(tmp_path / "ck")
    ids = np.frombuffer(text.read_bytes(), np.uint8).astype(np.int32)
    want = j_perplexity(jparams, dataclasses.replace(
        jcfg, kv_bits=4, dtype="float32", kernel_mode="xla"), ids,
        window=32, limit_windows=2)
    assert ev["tokens"] == want["tokens"] == 64
    assert abs(ev["nll"] - want["nll"]) <= 1e-4
    assert t_cli(["generate", str(tmp_path / "ck"), "--prompt-ids",
                  "1,2,3;4,5", "--max-new", "3", "--eos-id", "-1",
                  "--kv-bits", "4", "--device", "cpu"]) == 0
    outs = [json.loads(x)["output"]
            for x in capsys.readouterr().out.splitlines()]
    eng = TEngine(tllama.init_params(tc8, seed=0, device="cpu"), tc,
                  max_slots=8, max_seq=1024, eos_id=-1, device="cpu")
    assert outs == eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)


# ── the MLA latent cache at kv_bits=16 ───────────────────────────────────


def test_mla_kv16_forward_matches_jax():
    """test-tiny-mla with the unquantized latent cache (the plain MLA path,
    as the JAX package runs it): a 12-token prefill and 3 decode steps at
    B=2, the port's plain and kernel modes against JAX ``forward``, 1e-4 of
    max|logit|; the cache holds the latent rows in the activation type."""
    jc = dataclasses.replace(JPRESETS["test-tiny-mla"], kv_bits=16,
                             dtype="float32", kernel_mode="xla")
    tc = TConfig(**dataclasses.asdict(jc))
    tllama.check_supported(tc)
    jp = jllama.init_params(jc, seed=3)
    tparams = params_from_flat(jax.tree.map(np.asarray, _flatten_params(jp)),
                               tc, "cpu")
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)] + [
        rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        for _ in range(3)]
    ref, _ = _forward_run(
        lambda p, x, c, cfg: _jit_forward(p, jnp.asarray(x), c, cfg=cfg),
        jp, jc, jllama.init_cache(jc, 2, 64), toks,
        lambda lg: np.asarray(lg, np.float32))
    for mode in ("xla", "auto"):
        c = dataclasses.replace(tc, kernel_mode=mode)
        cache = tllama.init_cache(c, 2, 64, "cpu")
        assert cache.k_codes.dtype == torch.float32
        got, cache = _forward_run(
            lambda p, x, cc, cfg: tllama.forward(p, torch.from_numpy(x), cc,
                                                 cfg, device="cpu"),
            tparams, c, cache, toks, lambda lg: lg.numpy())
        for r, g in zip(ref, got):
            err = np.max(np.abs(r - g)) / np.max(np.abs(r))
            assert err <= 1e-4, (mode, err)
        assert torch.all(cache.k_scale[:, :, :, :15] == 1.0)


def test_kv4_configs_and_caches(tmp_path):
    """Both packages refuse an odd ``n_kv_heads`` and MLA at ``kv_bits=4``;
    the port's caches hold uint8 codes of ``Hkv/2`` heads beside scales of
    ``Hkv``; ``check_supported`` takes Llama-3-8B at kv4 and
    DeepSeek-V2-Lite at kv16; a checkpoint whose config says
    ``kv_bits: 4`` loads as written."""
    for cls in (JConfig, TConfig):
        base = dataclasses.asdict(JPRESETS["test-tiny"])
        with pytest.raises(ValueError, match="even n_kv_heads"):
            cls(**{**base, "kv_bits": 4, "n_kv_heads": 1, "n_heads": 4})
        with pytest.raises(ValueError, match="kv_bits 8|16"):
            cls(**{**dataclasses.asdict(JPRESETS["test-tiny-mla"]),
                   "kv_bits": 4})
    tllama.check_supported(dataclasses.replace(TPRESETS["llama-3-8b"],
                                               kv_bits=4))
    tllama.check_supported(dataclasses.replace(TPRESETS["deepseek-v2-lite"],
                                               kv_bits=16))
    _, tc = _tiny()
    c = tllama.init_cache(tc, 3, 16, "cpu")
    p = tllama.init_paged_cache(tc, 3, 16, 7, 8, device="cpu")
    l, h, d = tc.n_layers, tc.n_kv_heads, tc.head_dim
    for cache, lead in ((c, (l, 3)), (p, (l, 7))):
        for codes, scale in ((cache.k_codes, cache.k_scale),
                             (cache.v_codes, cache.v_scale)):
            assert codes.dtype == torch.uint8 and scale.dtype == torch.float32
            assert tuple(codes.shape[:3]) == lead + (h // 2,)
            assert codes.shape[-1] == d and scale.shape[2] == h
            assert codes.shape[3] == scale.shape[3]
    t_save(tmp_path / "kv4", tllama.init_params(tc, seed=0, device="cpu"), tc)
    _, loaded = t_load(tmp_path / "kv4", device="cpu")
    assert loaded.kv_bits == 4


# ── the CUDA kernels against their plain versions (the card) ─────────────


def _check_decode(gen, kernel, plain, name, shape):
    """A kv4 decode call against its plain version with f32 q (1e-4 of
    max|ref|, and 1e-4 absolute) and bf16 q (1e-2): one launch counted on
    its path and under [kv4], slot 0 (length 0) all zeros, a second call
    bit-equal to the first."""
    for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn(shape, generator=gen, device=gen.device).to(qdt)
        _build.reset_launches()
        got = kernel(q)
        path = "tc" if qdt == torch.bfloat16 and shape[2] % 32 == 0 \
            else "cuda_core"
        assert (_build.launches[f"{name}[{path}]"] == 1
                == _build.launches[name] == _build.launches[f"{name}[kv4]"]
                ), (name, shape, qdt)
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
@pytest.mark.parametrize("page", [None, 16, 128])
def test_kv4_decode_matches_plain_on_card(page):
    """Both GQA decode kernels over the int4 head-pair cache against their
    plain versions: Dh 64, 128 and 256, rep 1, 2, 4 and 8, Hkv 2 and 4 (one
    and two packed heads), f32 and bf16 q, lengths at the plan's chunk
    edges, windows 0, 65 and 1000 with softcaps 0 and 50; contiguous and
    paged at pages 16 and 128 (entries past each slot's pages on the
    scratch page 0). Codes draw every nibble value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(page or 1)
    _build.build(("flash_decode",))
    l, s, b = 2, 600, 8
    for h in (2, 4):
        for d in (64, 128, 256):
            if page:
                max_pages = -(-s // page)
                cap = max_pages * page
                lead = lambda hh: (l, 1 + b * max_pages, hh, page)
            else:
                cap = s
                lead = lambda hh: (l, b, hh, s)
            kv = [torch.randint(0, 256, lead(h // 2) + (d,), generator=gen,
                                device=dev, dtype=torch.int32).to(
                                    torch.uint8),
                  torch.rand(lead(h), generator=gen, device=dev) * 0.05]
            kv += [torch.randint(0, 256, lead(h // 2) + (d,), generator=gen,
                                 device=dev, dtype=torch.int32).to(
                                     torch.uint8),
                   torch.rand(lead(h), generator=gen, device=dev) * 0.05]
            for w, cap_, scale in ((0, 0.0, None), (65, 50.0, 1 / 16),
                                   (1000, 0.0, None)):
                opts = dict(softcap=cap_, scale=scale)
                for rep in (1, 2, 4, 8):
                    ch = att.decode_plan(b, h, cap, rep, d, window=w,
                                         kv4=True).chunk
                    lengths = [0, 1, 65, ch - 1, ch + 1, 300, 599, cap]
                    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
                    if page:
                        used = [min(max_pages, n // page + 1) if n else 0
                                for n in lengths]
                        perm = torch.randperm(b * max_pages, generator=gen,
                                              device=dev) + 1
                        tbl = torch.zeros((b, max_pages), dtype=torch.int32,
                                          device=dev)
                        for i, u in enumerate(used):
                            tbl[i, :u] = perm[i * max_pages:
                                              i * max_pages + u]
                        _check_decode(
                            gen, lambda q: paged_flash_decode_int8(
                                q, *kv, tbl, ln, 1, w, **opts),
                            lambda q: paged_attention_reference(
                                q, *kv, tbl, ln, 1, w, **opts),
                            "paged_flash_decode_int8", (b, h * rep, d))
                    else:
                        _check_decode(
                            gen, lambda q: flash_decode_int8(
                                q, *kv, ln, 1, w, **opts),
                            lambda q: flash_decode_int8_reference(
                                q, *kv, ln, 1, w, **opts),
                            "flash_decode_int8", (b, h * rep, d))


def _bits(t):
    """A float tensor's bits, for bit-equality."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.gpu
@pytest.mark.parametrize("layout,at", [("contiguous", 0), ("contiguous", 64),
                                       ("paged", 16)])
def test_kv4_fused_insert_matches_plain_on_card(layout, at):
    """The fused RoPE + K/V quantize + insert at ``kv_bits=4`` against its
    plain version (RoPE, ``quantize_kv(.., 4)``, the codes-in insert) on
    the card: every cache byte equal (the packed codes and the scales), the
    rotated q bit-equal; f32 and bf16, Dh 64, 128 and 256, Hkv 2 and 8,
    rep 1 and 4, q, k and v strided views of one projection row and again
    contiguous with a yarn factor; a slot at capacity, a parked slot (paged:
    the scratch page 0), at s0 64 positions another shard owns. Each call
    counted once, under [fused] and [kv4]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(at + 7)
    _build.build(("cache_insert",))
    l, s = 2, 256
    paged = layout == "paged"
    lengths = [0, 1, 37, 127, 128, 200, s - 1, s + (0 if paged else at)]
    b = len(lengths)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    name = "paged_cache_insert_int8" if paged else "cache_insert_int8"
    if paged:
        max_pages = s // at
        n_pool = 1 + b * max_pages
        used = [min(max_pages, n // at + 1) if n else 0 for n in lengths]
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev) + 1
        tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
        for i, u in enumerate(used):
            tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
    for dt in (torch.float32, torch.bfloat16):
        for hkv in (2, 8):
            for dh in (64, 128, 256):
                lead = ((l, n_pool, hkv, at) if paged else (l, b, hkv, s))
                clead = lead[:2] + (hkv // 2,) + lead[3:]
                cache = [torch.randint(0, 256, clead + (dh,), generator=gen,
                                       device=dev, dtype=torch.int32).to(
                                           torch.uint8),
                         torch.rand(lead, generator=gen, device=dev) * 0.02]
                cache += [torch.randint(0, 256, clead + (dh,), generator=gen,
                                        device=dev, dtype=torch.int32).to(
                                            torch.uint8),
                          torch.rand(lead, generator=gen, device=dev) * 0.02]
                freqs = 500000.0 ** (-torch.arange(
                    dh // 2, device=dev, dtype=torch.float64) / (dh // 2))
                ang = ln.double()[:, None, None, None] * freqs
                cos, sin = ang.cos().float(), ang.sin().float()
                for rep in (1, 4):
                    hq = hkv * rep
                    row = torch.randn((b, 1, (hq + 2 * hkv) * dh),
                                      generator=gen, device=dev).to(dt)
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
                                attn_factor=factor, kv_bits=4)
                            ref = paged_cache_insert_int8_fused_reference(
                                q, k, v, cos, sin, *plain, ln, 1, tbl,
                                attn_factor=factor, kv_bits=4)
                        else:
                            got = cache_insert_int8_fused(
                                q, k, v, cos, sin, *cache, ln, 1, at,
                                attn_factor=factor, kv_bits=4)
                            ref = cache_insert_int8_fused_reference(
                                q, k, v, cos, sin, *plain, ln, 1, at,
                                attn_factor=factor, kv_bits=4)
                        torch.cuda.synchronize()
                        what = (layout, at, dt, hkv, dh, rep, views)
                        assert (_build.launches[name]
                                == _build.launches[f"{name}[fused]"]
                                == _build.launches[f"{name}[kv4]"] == 1), what
                        assert torch.equal(_bits(got), _bits(ref)), what
                        for a, r in zip(cache, plain):
                            assert torch.equal(_bits(a), _bits(r)), what
