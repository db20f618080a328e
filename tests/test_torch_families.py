"""The dense families past Llama and the unquantized KV cache, the port
against the JAX package (CPU).

* The plain versions of the two GQA decode kernels (the wrappers' CPU
  dispatch) against the JAX Pallas kernels in interpret mode, contiguous,
  stacked and paged: sliding windows of 0, 16, 100 and 300 over a
  256-token context (straddling the 64-token tiles, one longer than the
  context) and a tanh softcap of 30 under a ``query_pre_attn_scalar``
  scale, within 2e-5 (the JAX kernel tests' tolerance).
* ``forward`` against JAX ``forward`` (``kernel_mode="xla"``) on tiny
  configs of Qwen2 (q/k/v bias), Mistral (every layer windowed), Gemma
  (offset norms, tanh GeLU, scaled embeddings, decoupled head_dim),
  Gemma-2 (local and global layers, both softcaps, post norms, query
  scalar), Gemma-3 (local and global rope bases, offset QK norms) and
  Llama at ``kv_bits=16``: one 12-token prefill and 4 decode steps at B=2
  with a window of 8, so decode reads past it; contiguous for all, paged
  for Gemma-2 and kv16; the port in its plain mode and in kernel mode.
  The biases and every norm gain are drawn from the seed before the
  transfer (the JAX init leaves them at zeros and ones), so a dropped bias
  or offset fails. Tolerance as ``tests/test_torch_llama.py``: 1e-4 of
  max|logit|, 1e-3 from a slot's first KV code that differs by a rounding
  tie; at ``kv_bits=16`` 1e-4 throughout.
* The port's ``Engine`` (contiguous, and paged with prefix caching over a
  pool small enough to preempt) gives the JAX ``Engine``'s greedy streams
  on the tiny Gemma-2, with prompts longer than its window: exact tokens.
* A tiny random Hugging Face Gemma-2 built with ``transformers``,
  converted by the port and by the JAX converter (byte-equal files),
  loaded by each: the port's logits against the JAX forward's.
* ``load_checkpoint`` refuses a config outside the port before it decodes
  a blob; ``check_supported`` takes the family presets and still names
  what it refuses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint import convert_hf_llama as j_convert
from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.checkpoint.format import load_checkpoint as j_load
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.attention import flash_decode_int8 as j_flash
from quant_tpu.kernels.paged_attention import (
    paged_flash_decode_int8 as j_paged_flash)
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu.models.config import ModelConfig as JConfig
from quant_tpu_torch.checkpoint import format as t_format
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.checkpoint.hf import convert_hf_llama as t_convert
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.kernels.attention import flash_decode_int8
from quant_tpu_torch.kernels.paged_attention import paged_flash_decode_int8
from quant_tpu_torch.models import PRESETS as TPRESETS
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

os.environ.setdefault("USE_TF", "0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── the decode kernels' plain versions against the Pallas kernels ────────

_WINDOWS = (0, 16, 100, 300)
_S, _HQ, _HKV, _DH, _PAGE = 256, 4, 2, 64, 16
_QPAS = 32.0                      # query_pre_attn_scalar: scale 32^-0.5
_jit_flash = jax.jit(j_flash, static_argnames=("s_blk", "interpret",
                                               "softcap", "scale"))
_jit_paged = jax.jit(j_paged_flash, static_argnames=("interpret", "softcap",
                                                     "scale"))


def _decode_inputs(layers: int):
    """q [B, Hq, Dh] (scaled so the logits sit in tanh's active range at a
    cap of 30), int8 caches ``[L, B, Hkv, S, Dh]`` quantized as the model
    writes them, lengths [250, 37]."""
    rng = np.random.default_rng(11)
    b = 2
    q = (4.0 * rng.standard_normal((b, _HQ, _DH))).astype(np.float32)
    kv = []
    for _ in range(2):
        x = rng.standard_normal((layers, b, _S, _HKV, _DH)).astype(np.float32)
        c, s = (np.asarray(a) for a in jllama.quantize_kv(jnp.asarray(x)))
        kv += [np.ascontiguousarray(c.transpose(0, 1, 3, 2, 4)),
               np.ascontiguousarray(s.transpose(0, 1, 3, 2))]
    return q, kv, np.asarray([250, 37], np.int32)


def _to_pool(a, tbl):
    """Slot rows ``[L, B, H, S, ..]`` into a page pool ``[L, P, H, page,
    ..]`` under ``tbl`` (page 0 left as zeros)."""
    l, b, h, s = a.shape[:4]
    pool = np.zeros((l, 1 + tbl.size, h, _PAGE) + a.shape[4:], a.dtype)
    for bi in range(b):
        for j in range(s // _PAGE):
            pool[:, tbl[bi, j]] = a[:, bi, :, j * _PAGE:(j + 1) * _PAGE]
    return pool


@pytest.mark.parametrize("layout", ["contiguous", "stacked", "paged"])
def test_decode_window_softcap_match_pallas(layout):
    layers = 1 if layout == "contiguous" else 2
    q, kv, lengths = _decode_inputs(layers)
    layer = layers - 1
    tbl = np.random.default_rng(3).permutation(
        np.arange(1, 1 + 2 * _S // _PAGE)).reshape(2, -1).astype(np.int32)
    if layout == "paged":
        kv = [_to_pool(a, tbl) for a in kv]
    elif layout == "contiguous":
        kv = [a[0] for a in kv]
    jkv = [jnp.asarray(a) for a in kv]
    tkv = [torch.from_numpy(a) for a in kv]
    scale = _QPAS ** -0.5
    outs = {}
    for softcap in (0.0, 30.0):
        for w in _WINDOWS:
            if layout == "paged":
                ref = _jit_paged(jnp.asarray(q), *jkv, jnp.asarray(tbl),
                                 jnp.asarray(lengths), jnp.int32(layer),
                                 jnp.int32(w), interpret=True,
                                 softcap=softcap, scale=scale)
                got = paged_flash_decode_int8(
                    torch.from_numpy(q), *tkv, torch.from_numpy(tbl),
                    torch.from_numpy(lengths), layer, w, softcap=softcap,
                    scale=scale)
            else:
                ref = _jit_flash(jnp.asarray(q), *jkv, jnp.asarray(lengths),
                                 None if layout == "contiguous"
                                 else jnp.int32(layer), jnp.int32(w),
                                 s_blk=64, interpret=True, softcap=softcap,
                                 scale=scale)
                got = flash_decode_int8(
                    torch.from_numpy(q), *tkv, torch.from_numpy(lengths),
                    None if layout == "contiguous" else layer, w,
                    softcap=softcap, scale=scale)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=2e-5, atol=2e-5)
            outs[softcap, w] = got.numpy()
    # the window masks slot 0 (250 tokens) at 16 and 100 but not at 300,
    # slot 1 (37 tokens) only at 16; the softcap changes every output
    assert np.array_equal(outs[0.0, 300], outs[0.0, 0])
    assert not np.allclose(outs[0.0, 100][0], outs[0.0, 0][0], atol=1e-3)
    assert np.array_equal(outs[0.0, 100][1], outs[0.0, 0][1])
    assert not np.allclose(outs[0.0, 16][1], outs[0.0, 0][1], atol=1e-3)
    assert not np.allclose(outs[30.0, 0], outs[0.0, 0], atol=1e-3)


# ── forward, family by family ────────────────────────────────────────────

_BASE = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             intermediate=512, group_size=64, kernel_mode="xla",
             dtype="float32")
_GEMMA = dict(norm_offset=1.0, act_fn="gelu_tanh", embed_scale=True,
              embed_bits=8, norm_eps=1e-6)
# each family's tiny config: its knobs at test-tiny's widths, windows of 8
# tokens (the context reaches 16), a local and a global layer where the
# family alternates them
FAMILY_CFGS = {
    "qwen2": dict(qkv_bias=True, rope_theta=1e6, norm_eps=1e-6),
    "mistral": dict(sliding_window=8),
    "gemma": dict(_GEMMA, head_dim=128),
    "gemma2": dict(_GEMMA, sliding_window=8, sliding_pattern=2,
                   attn_softcap=10.0, final_softcap=5.0, post_norms=True,
                   query_pre_attn_scalar=32.0),
    "gemma3": dict(_GEMMA, sliding_window=8, sliding_pattern=2,
                   post_norms=True, qk_norm=True, query_pre_attn_scalar=32.0,
                   rope_theta=1e6, rope_local_theta=1e4,
                   rope_scaling="linear", rope_factor=2.0),
    "llama-kv16": dict(kv_bits=16),
}


def _jc(name: str):
    return JConfig(**_BASE, **FAMILY_CFGS[name])


def _tc(jc):
    return TConfig(**dataclasses.asdict(jc))


def _drawn_params(jc, seed: int = 3):
    """JAX ``init_params`` with the bias (where the family has one) and
    every norm gain drawn from ``seed``: gains near 1, or near 0 as deltas
    from Gemma's offset."""
    jp = jllama.init_params(jc, seed=seed)
    rng = np.random.default_rng(seed)
    base = 0.0 if jc.norm_offset else 1.0

    def gain(shape):
        return jnp.asarray(base + 0.1 * rng.standard_normal(shape),
                           jnp.float32)
    lay = jp.layers
    l, d, hd = jc.n_layers, jc.dim, jc.head_dim
    new = dict(attn_norm=gain((l, d)), mlp_norm=gain((l, d)),
               q_norm=gain((l, hd)), k_norm=gain((l, hd)))
    if jc.post_norms:
        new.update(post_attn_norm=gain((l, d)), post_mlp_norm=gain((l, d)))
    if jc.qkv_bias:
        new["qkv_bias"] = jnp.asarray(
            0.1 * rng.standard_normal(lay.qkv_bias.shape), jnp.float32)
    return dataclasses.replace(jp, layers=dataclasses.replace(lay, **new),
                               final_norm=gain((d,)))


_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))
_B, _T, _STEPS, _MAX_SEQ, _FPAGE = 2, 12, 4, 32, 8


def _tokens(vocab: int):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (_B, _T)).astype(np.int32)] + [
        rng.integers(0, vocab, (_B, 1)).astype(np.int32)
        for _ in range(_STEPS)]


def _table():
    n = _MAX_SEQ // _FPAGE
    return np.random.default_rng(5).permutation(
        np.arange(1, 1 + _B * n)).reshape(_B, n).astype(np.int32)


def _slot_rows(codes, paged: bool):
    """Cache codes as ``[L, B, H, S, D]`` (a pool gathered through the
    table)."""
    if not paged:
        return codes
    g = codes[:, _table()]                  # [L, B, n, H, page, D]
    g = np.moveaxis(g, 3, 2)
    return g.reshape(*g.shape[:3], -1, *g.shape[5:])


def _run_jax(jparams, jc, toks, paged: bool):
    if paged:
        cache = dataclasses.replace(
            jllama.init_paged_cache(jc, _B, _MAX_SEQ, 1 + _table().size,
                                    _FPAGE),
            page_tbl=jnp.asarray(_table()))
    else:
        cache = jllama.init_cache(jc, _B, _MAX_SEQ)
    outs = []
    for x in toks:
        lg, cache = _jit_forward(jparams, jnp.asarray(x), cache, cfg=jc)
        outs.append(np.asarray(lg, np.float32))
    return outs, [np.asarray(cache.k_codes), np.asarray(cache.v_codes)]


def _run_port(tparams, tc, toks, paged: bool):
    if paged:
        cache = tllama.init_paged_cache(tc, _B, _MAX_SEQ, 1 + _table().size,
                                        _FPAGE, device="cpu")
        cache.page_tbl.copy_(torch.from_numpy(_table()))
    else:
        cache = tllama.init_cache(tc, _B, _MAX_SEQ, "cpu")
    outs = []
    for x in toks:
        lg, cache = tllama.forward(tparams, torch.from_numpy(x), cache, tc,
                                   device="cpu")
        outs.append(lg.numpy())
    return outs, [cache.k_codes.numpy(), cache.v_codes.numpy()]


def _assert_logits_close(ref, got, j_codes, t_codes, kv_bits, paged, what):
    """1e-4 of max|logit|, or 1e-3 from a slot's first int8 code that
    differs (by one step, in at most 0.1% of the codes); kv16: 1e-4."""
    tainted = np.zeros((_B, _MAX_SEQ), bool)
    if kv_bits == 8:
        diff = np.zeros((_B, _MAX_SEQ), bool)
        for jc_, tc_ in zip(j_codes, t_codes):
            d = np.abs(jc_.astype(np.int32) - tc_.astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, what
            diff |= (_slot_rows(d, paged) > 0).any(axis=(0, 2, 4))
        tainted = np.cumsum(diff, axis=1) > 0
    pos0 = 0
    for r, g in zip(ref, got):
        assert r.shape == g.shape and np.isfinite(g).all()
        err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
        tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
        assert np.all(err <= tol), (what, err)
        pos0 += r.shape[1]


_FWD_CASES = [(name, False) for name in FAMILY_CFGS] + [
    ("gemma2", True), ("llama-kv16", True)]


@pytest.mark.parametrize("name,paged", _FWD_CASES)
def test_forward_matches_jax(name, paged):
    jc = _jc(name)
    tc = _tc(jc)
    tllama.check_supported(tc)
    jparams = _drawn_params(jc)
    tparams = params_from_flat(jax.tree.map(np.asarray,
                                            _flatten_params(jparams)),
                               tc, "cpu")
    toks = _tokens(jc.vocab_size)
    ref, j_codes = _run_jax(jparams, jc, toks, paged)
    for mode in ("xla", "auto"):
        got, t_codes = _run_port(tparams, dataclasses.replace(
            tc, kernel_mode=mode), toks, paged)
        _assert_logits_close(ref, got, j_codes, t_codes, jc.kv_bits, paged,
                             (name, mode))
    if jc.kv_bits == 16:
        assert t_codes[0].dtype == np.float32
    if jc.final_softcap:
        assert max(np.abs(r).max() for r in ref) <= jc.final_softcap


def test_kernel_mode_passes_windows_and_softcap(monkeypatch):
    """Decode in kernel mode hands each layer's window (local 8, global 0)
    and the softcap to the flash kernel, with the local rope tables on the
    local layer; kv16 decodes on the plain path."""
    calls = []
    real = tllama.flash_decode_int8

    def spy(*a, **kw):
        calls.append((a[6], a[7], kw["softcap"]))
        return real(*a, **kw)
    monkeypatch.setattr(tllama, "flash_decode_int8", spy)
    for name in ("gemma2", "llama-kv16"):
        tc = dataclasses.replace(_tc(_jc(name)), kernel_mode="auto")
        params = tllama.init_params(tc, seed=0, device="cpu")
        cache = tllama.init_cache(tc, _B, _MAX_SEQ, "cpu")
        toks = _tokens(tc.vocab_size)
        for x in toks[:2]:
            _, cache = tllama.forward(params, torch.from_numpy(x), cache, tc,
                                      device="cpu")
    assert calls == [(0, 8, 10.0), (1, 0, 10.0)]
    assert tllama.layer_windows(_tc(_jc("gemma2"))) == list(
        np.asarray(jllama.layer_windows(_jc("gemma2"))))
    for preset in ("mistral-7b", "gemma-2-9b", "gemma-3-1b"):
        assert tllama.layer_windows(TPRESETS[preset]) == list(
            np.asarray(jllama.layer_windows(JPRESETS[preset])))
    # Gemma-3's two rope bases against the JAX per-layer theta, at the
    # forward's positions (the frequencies come from two float32 powers,
    # numpy's and XLA's, an ulp apart, which a large position magnifies)
    jc = _jc("gemma3")
    tc = _tc(jc)
    pos = np.arange(2 * 20, dtype=np.int32).reshape(2, 20)
    x = np.random.default_rng(2).standard_normal((2, 20, 2, 64)).astype(
        np.float32)
    sets = tllama._rope_sets(torch.from_numpy(pos), tc, 64)
    for kind, w in (("local", 8), ("global", 0)):
        ref = jllama._rope(jnp.asarray(x), jnp.asarray(pos), jc.rope_theta,
                           jc, theta_override=jllama._layer_theta(
                               jc, jnp.int32(w)))
        got = tllama._rope_apply(torch.from_numpy(x), *sets[kind], tc)
        assert np.max(np.abs(got.numpy() - np.asarray(ref))) <= 1e-5, kind


# ── the engine ───────────────────────────────────────────────────────────


def _engine_prompts():
    """Two prompts sharing two 8-token blocks, and a third of 21 tokens:
    each longer than the window of 8."""
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(3, 512, 16)]
    return [shared + [int(t) for t in rng.integers(3, 512, 6)],
            shared + [int(t) for t in rng.integers(3, 512, 3)],
            [int(t) for t in rng.integers(3, 512, 21)]]


def _drive(eng, make_req):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_engine_prompts())]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


_ENGINES = {"contiguous": dict(max_slots=2, max_seq=48, eos_id=-1),
            "paged-prefix": dict(max_slots=2, max_seq=48, eos_id=-1,
                                 paged=True, page_size=8, n_pages=7,
                                 prefix_cache=True)}


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_gemma2_engine_matches_jax(kind):
    """Greedy streams of three requests (22, 19 and 21 prompt tokens, the
    first two sharing two blocks; 6 new, two slots) past the window of 8
    equal the JAX engine's; the paged engine reuses the shared blocks and
    its 7-page pool preempts."""
    jc = _jc("gemma2")
    tc = dataclasses.replace(_tc(jc), kernel_mode="auto")
    jparams = _drawn_params(jc, seed=4)
    tparams = params_from_flat(jax.tree.map(np.asarray,
                                            _flatten_params(jparams)),
                               tc, "cpu")
    want = _drive(JEngine(jparams, jc, **_ENGINES[kind]), JRequest)
    eng = TEngine(tparams, tc, device="cpu", **_ENGINES[kind])
    preempted = []
    inner = eng._preempt_newest

    def counted(*a):
        preempted.append(1)
        return inner(*a)
    eng._preempt_newest = counted
    assert _drive(eng, TRequest) == want
    assert all(len(o) == 6 for o in want)
    if kind == "paged-prefix":
        assert preempted and eng.stats["prefix_hit_tokens"] > 0


# ── the real entry path: a Hugging Face Gemma-2 ──────────────────────────


def _hf_gemma2(path):
    """A tiny ``Gemma2ForCausalLM`` (its own random init, norm gains drawn
    as deltas), written as F32 safetensors with its config."""
    from safetensors.numpy import save_file
    from transformers import Gemma2Config, Gemma2ForCausalLM

    hcfg = Gemma2Config(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, sliding_window=8, query_pre_attn_scalar=32,
        attn_logit_softcapping=10.0, final_logit_softcapping=5.0,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=True)
    torch.manual_seed(0)
    model = Gemma2ForCausalLM(hcfg)
    rng = np.random.default_rng(9)
    sd = {}
    for k, v in model.state_dict().items():
        if k == "lm_head.weight" or "rotary" in k:
            continue
        a = v.detach().float().numpy()
        if "norm" in k:
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif a.ndim == 2:
            a = (rng.standard_normal(a.shape) / np.sqrt(a.shape[1])).astype(
                np.float32)
        sd[k] = np.ascontiguousarray(a)
    path.mkdir()
    save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(hcfg.to_dict()))


def test_hf_gemma2_convert_load_matches_jax(tmp_path):
    hf = tmp_path / "hf"
    _hf_gemma2(hf)
    j_convert(hf, tmp_path / "j", bits=4, group_size=64)
    t_convert(hf, tmp_path / "t", bits=4, group_size=64, device="cpu")
    for f in ("manifest.json", "data.bin"):
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f
    tparams, tc = t_load(tmp_path / "t", device="cpu")
    jparams, jc = j_load(tmp_path / "j")
    jc = dataclasses.replace(jc, dtype="float32", kernel_mode="xla")
    assert tc.sliding_window == 8 and tc.post_norms and tc.attn_softcap
    tc = _tc(jc)
    toks = [x[:, :10] if x.shape[1] > 1 else x for x in _tokens(512)]
    ref, j_codes = _run_jax(jparams, jc, toks, False)
    got, t_codes = _run_port(tparams, dataclasses.replace(
        tc, kernel_mode="auto"), toks, False)
    _assert_logits_close(ref, got, j_codes, t_codes, 8, False, "hf-gemma2")


# ── what the loader and check_supported take and refuse ──────────────────


def test_loader_refuses_before_decoding(tmp_path, monkeypatch):
    """A checkpoint whose config the port refuses (act_quant, W8A8) raises
    naming it before a single blob is decoded; the same file without it
    decodes and loads."""
    tc = TConfig(**dataclasses.asdict(JPRESETS["test-tiny"]))
    t_save(tmp_path / "ok", tllama.init_params(tc, seed=0, device="cpu"), tc)
    manifest = json.loads((tmp_path / "ok" / "manifest.json").read_text())
    manifest["config"]["act_quant"] = True
    (tmp_path / "w8a8").mkdir()
    (tmp_path / "w8a8" / "manifest.json").write_text(json.dumps(manifest))
    (tmp_path / "w8a8" / "data.bin").write_bytes(
        (tmp_path / "ok" / "data.bin").read_bytes())
    decoded = []
    real = t_format._read_leaf

    def counted(*a):
        decoded.append(1)
        return real(*a)
    monkeypatch.setattr(t_format, "_read_leaf", counted)
    with pytest.raises(NotImplementedError, match="act_quant"):
        t_load(tmp_path / "w8a8", device="cpu")
    assert not decoded
    t_load(tmp_path / "ok", device="cpu")
    assert decoded


def test_check_supported_takes_the_families():
    for preset in ("qwen2-7b", "mistral-7b", "gemma-7b", "gemma-2-2b",
                   "gemma-2-9b", "gemma-3-1b"):
        tllama.check_supported(TPRESETS[preset])
    for kv_bits in (16, 4):
        tllama.check_supported(dataclasses.replace(TPRESETS["llama-3-8b"],
                                                   kv_bits=kv_bits))
    tllama.check_supported(dataclasses.replace(TPRESETS["deepseek-v2-lite"],
                                               kv_bits=16))
    refused = [
        ("llama-3-8b", {"embed_bits": 4}, "embed_bits=4"),
        ("llama-3-8b", {"codebook": "nf4"}, "codebook"),
        ("llama-3-8b", {"act_quant": True}, "act_quant"),
        ("mixtral-8x7b", {"moe_prefill": "capacity"}, "capacity"),
        ("deepseek-v2-lite", {"moe_fused": False}, "moe_fused"),
    ]
    for preset, change, name in refused:
        with pytest.raises(NotImplementedError, match=name):
            tllama.check_supported(dataclasses.replace(TPRESETS[preset],
                                                       **change))
