"""The port's DeepSeek path (MLA, shared experts, dense prefix) against the
JAX package (CPU).

Every JAX result comes from one module-scoped run per kind (``jax_*``
fixtures), on the same numpy inputs as the port; JAX parameters are carried
across with ``params_from_flat``. Configs: ``test-tiny-mla`` (direct q,
dense MLP) and ``test-tiny-dsv3`` (low-rank q, 8 experts top-2 with 2 shared
experts, one dense-prefix layer, sigmoid group-limited top-2-sum routing
with a selection bias) in float32, and ``test-tiny-mla`` in bfloat16.

* Config fields and rope tables: yarn frequencies, the attention factor and
  ``_q_scale`` (with ``score_mscale``) equal to the JAX package's within
  1e-7; interleaved yarn rope within 1e-5 (cos/sin of one float32 angle in
  two libraries).
* ``mla_flash_decode_int8_reference`` against the JAX kernel run with
  ``interpret=True``: within 1e-4 (the tolerance of ``tests/test_mla.py``'s
  kernel unit test). ``mla_cache_insert_int8_reference`` (the codes-in
  insert) against the JAX kernel in interpret mode: byte-equal. The fused
  latent insert ``mla_cache_insert_int8_fused`` on the CPU (its plain
  version) against the JAX chain (``rmsnorm``, interleaved yarn ``_rope``,
  concatenate and pad, ``quantize_kv``, the Pallas insert in interpret
  mode): q_eff as the rope tolerance below, codes within the rounding-tie
  rule.
* ``forward`` logits and the whole latent cache against
  ``llama.forward(kernel_mode="xla")`` for a prefill then three decode
  steps, in the port's plain mode ("xla") and its kernel mode ("auto"), and
  the decode steps against JAX ``"pallas_interpret"`` (the MLA Pallas pair)
  from the same prefilled cache. Tolerances of ``tests/test_torch_llama.py``:
  float32 logits within 1e-4 * max|logit| (1e-3 after a latent code that
  differs by one step: a rounding tie of ``quantize_kv``), bfloat16 within
  3e-2; latent codes differ by at most one step in at most 0.1% of entries,
  scales within 1e-5 relative, and the dequantized latent within 2e-3 of
  its max (the tolerance ``tests/test_mla.py`` holds the Pallas pair to).
  Measured on these inputs: no latent code differs, every float32 logit row
  within 2.3e-6 of max|logit|.
* Greedy ``Engine`` streams token-identical to the JAX ``Engine`` on both
  toys (contiguous cache; the paged latent pool is
  ``tests/test_torch_mla_paged.py``).
* A ``test-tiny-dsv3`` checkpoint written by the JAX package loads in the
  port leaf for leaf, and the port's checkpoint of it equals the JAX one
  byte for byte (``data.bin``).

Routing near-ties: the tests record every routing decision of the port and
assert the selection margin (the gap between the k-th and (k+1)-th
selection score, and between the groups kept and the best group dropped):
at least 1e-5 in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.checkpoint.format import save_checkpoint as j_save
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.cache_insert import mla_cache_insert_int8 as j_insert
from quant_tpu.kernels.mla_attention import mla_flash_decode_int8 as j_mla
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.kernels.cache_insert import (
    mla_cache_insert_int8_fused, mla_cache_insert_int8_fused_reference,
    mla_cache_insert_int8_reference)
from quant_tpu_torch.kernels.mla_attention import (
    mla_flash_decode_int8, mla_flash_decode_int8_reference)
from quant_tpu_torch.models import PRESETS as TPRESETS
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(preset, dtype="float32", **kw):
    jc = dataclasses.replace(JPRESETS[preset], dtype=dtype, **kw)
    return jc, TConfig(**dataclasses.asdict(jc))


def _flat(jparams):
    return _flatten_params(jax.tree.map(np.asarray, jparams))


# ── config and rope ─────────────────────────────────────────────────────


@pytest.mark.parametrize("preset,cache_dim", [
    ("deepseek-v2-lite", 640), ("deepseek-v3", 640), ("test-tiny-mla", 128),
    ("test-tiny-dsv3", 128)])
def test_mla_configs_match_jax(preset, cache_dim):
    """The four MLA presets parse field for field as in the JAX package,
    with the 128-padded latent row (the cache layout both share)."""
    j, t = JPRESETS[preset], TPRESETS[preset]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.is_mla and t.n_kv_heads == 1
    assert t.mla_kv_dim == j.mla_kv_dim
    assert t.mla_cache_dim == j.mla_cache_dim == cache_dim
    assert t.head_dim == t.qk_nope_head_dim + t.qk_rope_head_dim
    tllama.check_supported(t)


@pytest.mark.parametrize("preset", ["deepseek-v2-lite", "deepseek-v3"])
def test_yarn_rope_and_score_scale_match_jax(preset):
    j, t = JPRESETS[preset], TPRESETS[preset]
    half = t.qk_rope_head_dim // 2
    want = np.asarray(jllama._rope_freqs(j.rope_theta, half, j))
    got = tllama._rope_freqs(t.rope_theta, half, t)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert tllama.yarn_attention_factor(t) == pytest.approx(
        jllama.yarn_attention_factor(j), rel=1e-7)
    assert tllama._q_scale(t, t.head_dim) == pytest.approx(
        jllama._q_scale(j, j.head_dim), rel=1e-7)
    if preset == "deepseek-v2-lite":
        # (0.1 * 0.707 * ln 40 + 1)^2 / sqrt(192)
        m = 0.1 * 0.707 * np.log(40.0) + 1.0
        assert tllama._q_scale(t, 192) == pytest.approx(
            m * m / np.sqrt(192.0), rel=1e-7)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, t.qk_rope_head_dim)).astype(np.float32)
    pos = rng.integers(0, 160000, (2, 5)).astype(np.int32)
    ref = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos),
                                  j.rope_theta, j))
    out = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos),
                       t.rope_theta, t).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-5


@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_linear_rope_matches_jax(factor):
    j, t = _configs("test-tiny", rope_scaling="linear", rope_factor=factor)
    np.testing.assert_array_equal(
        tllama._rope_freqs(t.rope_theta, 32, t),
        np.asarray(jllama._rope_freqs(j.rope_theta, 32, j)))


# ── the kernels' plain versions ─────────────────────────────────────────

# (heads, r, Dq, S, stacked): test-tiny-mla's latent, and a wider one
_ATT_CASES = [(4, 64, 128, 96, True), (16, 128, 256, 160, False)]


def _latent(rng, lead, s, dq):
    kf = rng.standard_normal(lead + (1, s, dq)).astype(np.float32)
    ks = (np.abs(kf).max(-1) / 127.0).astype(np.float32)
    kc = np.round(kf / ks[..., None]).astype(np.int8)
    return kc, ks


@pytest.fixture(scope="module")
def jax_mla_attention():
    out = {}
    for h, r, dq, s, stacked in _ATT_CASES:
        rng = np.random.default_rng(h + r)
        b = 4
        lead = (2, b) if stacked else (b,)
        kc, ks = _latent(rng, lead, s, dq)
        q = rng.standard_normal((b, h, dq)).astype(np.float32)
        lengths = np.array([0, 1, s // 2 + 3, s], np.int32)
        res = j_mla(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks),
                    jnp.asarray(lengths), jnp.int32(1) if stacked else None,
                    r=r, scale=0.125, s_blk=32, interpret=True)
        out[h, r] = (q, kc, ks, lengths, np.asarray(res))
    return out


@pytest.mark.parametrize("h,r,dq,s,stacked", _ATT_CASES)
def test_mla_flash_decode_matches_jax(jax_mla_attention, h, r, dq, s,
                                      stacked):
    q, kc, ks, lengths, ref = jax_mla_attention[h, r]
    args = [torch.from_numpy(a) for a in (q, kc, ks, lengths)]
    layer = 1 if stacked else None
    got = mla_flash_decode_int8(*args, layer, r=r, scale=0.125)
    # the CPU dispatch is the plain version
    assert torch.equal(got, mla_flash_decode_int8_reference(
        *args, layer, r=r, scale=0.125))
    assert got.shape == (4, h, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert not got[0].any()             # a slot of length 0 gives zeros


# the Pallas latent insert in interpret mode, layer and s0 traced: one trace
# for the codes-in test and the fused test's reference (the same shapes)
_jit_insert = jax.jit(functools.partial(j_insert, interpret=True))


@pytest.mark.parametrize("s0,lengths", [(0, [0, 5, 63, 64]),
                                        (32, [10, 40, 95, 96])])
def test_mla_cache_insert_matches_jax(s0, lengths):
    """Rows at ``lengths - s0`` inside [0, S) are written, others dropped
    (a slot at capacity, a position another sequence shard owns)."""
    rng = np.random.default_rng(s0)
    l, b, s, dq = 3, 4, 64, 128
    kc, ks = _latent(rng, (l, b), s, dq)
    new_c, new_s = _latent(rng, (b, 1), 1, dq)
    new_c, new_s = new_c[:, :, 0], new_s[:, :, 0]     # [B, 1, 1, Dq] / [B, 1, 1]
    ln = np.asarray(lengths, np.int32)
    jkc, jks = _jit_insert(jnp.asarray(kc), jnp.asarray(ks),
                           jnp.asarray(new_c), jnp.asarray(new_s),
                           jnp.asarray(ln), jnp.int32(2), jnp.int32(s0))
    tkc, tks = torch.from_numpy(kc.copy()), torch.from_numpy(ks.copy())
    mla_cache_insert_int8_reference(tkc, tks, torch.from_numpy(new_c),
                                    torch.from_numpy(new_s),
                                    torch.from_numpy(ln), 2, s0)
    assert tkc.numpy().tobytes() == np.asarray(jkc).tobytes()
    assert tks.numpy().tobytes() == np.asarray(jks).tobytes()
    assert not np.array_equal(tkc.numpy(), kc)


# the fused latent insert: (variant, dtype, s0). "mla": q_pe and ckv views
# of one down-projection row (test-tiny-mla's direct q); "dsv3": q_pe a
# view of the separate w_q_b output row (test-tiny-dsv3's low-rank q). Both
# take test-tiny-mla's widths (the two toys share them) and DeepSeek's yarn
# with mscale 1.0 over mscale_all_dim 0.707: an attention factor of 1.0857,
# so its product is exercised (the presets' factor is 1.0)
_FUSED_MLA = [(variant, dtype, s0) for variant in ("mla", "dsv3")
              for dtype in ("float32", "bfloat16") for s0 in (0, 32)]
_FUSED_LENGTHS = {0: [0, 5, 63, 64], 32: [10, 40, 95, 96]}
_FUSED_CFG = _configs("test-tiny-mla", rope_scaling="yarn", rope_factor=40.0,
                      rope_orig_max_pos=4096, rope_mscale=1.0,
                      rope_mscale_all_dim=0.707)


def _fused_mla_inputs(variant, s0):
    """Numpy inputs at 4 slots: the down-projection row ``akv`` ``[B, 1, q
    part + r + dr]`` (its q part the heads' [q_nope | q_pe] for "mla", the
    low-rank q for "dsv3"), the w_q_b output row (``None`` for "mla"),
    q_abs as ``[H, B, 1, r]`` (the einsum's layout), the RMSNorm gain, a
    3-layer latent cache of S 64 and the lengths: a slot at capacity, at
    s0 32 one before s0 (both dropped)."""
    jc = _FUSED_CFG[0]
    rng = np.random.default_rng([s0, variant == "mla"])
    b, h, r, dr = 4, jc.n_heads, jc.kv_lora_rank, jc.qk_rope_head_dim
    qw = h * (jc.qk_nope_head_dim + dr)
    q_part = (qw if variant == "mla"
              else JPRESETS["test-tiny-dsv3"].q_lora_rank)
    akv = rng.standard_normal((b, 1, q_part + r + dr), dtype=np.float32)
    q_row = (None if variant == "mla" else
             rng.standard_normal((b, 1, qw), dtype=np.float32))
    q_abs = rng.standard_normal((h, b, 1, r), dtype=np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(r)).astype(np.float32)
    kc, ks = _latent(rng, (3, b), 64, jc.mla_cache_dim)
    return (akv, q_row, q_abs, w, kc, ks,
            np.asarray(_FUSED_LENGTHS[s0], np.int32))


def _split(akv, q_row, cfg):
    """(ckv, q_pe) of the projection rows, as the model slices them."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    src = akv[..., :-(r + dr)] if q_row is None else q_row
    b = akv.shape[0]
    q_pe = src.reshape(b, 1, cfg.n_heads, -1)[..., cfg.qk_nope_head_dim:]
    return akv[..., -(r + dr):], q_pe


def _j_fused_rows(ckv, q_pe, q_abs, w, lengths, cfg):
    """The JAX forward's latent rows: ``rmsnorm`` of c, ``_rope`` of q_pe
    and k_pe, concatenate and pad: (q_eff, lat)."""
    r, dt = cfg.kv_lora_rank, q_abs.dtype
    pos = lengths[:, None]
    c = jllama.rmsnorm(ckv[..., :r], w, cfg.norm_eps)
    q_pe = jllama._rope(q_pe, pos, cfg.rope_theta, cfg)
    k_pe = jllama._rope(ckv[..., r:][:, :, None, :], pos, cfg.rope_theta,
                        cfg)
    pad = ((0, 0), (0, 0), (0, 0), (0, cfg.mla_cache_dim - cfg.mla_kv_dim))
    q_eff = jnp.pad(jnp.concatenate([q_abs, q_pe.astype(dt)], axis=-1), pad)
    lat = jnp.pad(jnp.concatenate([c, k_pe[:, :, 0].astype(c.dtype)],
                                  axis=-1)[:, :, None, :], pad)
    return q_eff, lat.astype(dt)


_jit_fused_rows = jax.jit(_j_fused_rows, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def jax_fused_mla():
    """(variant, dtype, s0) -> (q_eff as f32, latent codes, scales) of the
    JAX chain: the rows jitted (one trace per dtype), ``quantize_kv``
    eagerly (under ``jax.jit`` XLA may divide by another rounding of the
    scale, which moves codes at ties), then the Pallas latent insert at
    layer 2 with ``interpret=True``, jitted (s0 traced: one trace)."""
    out = {}
    for variant, dtype, s0 in _FUSED_MLA:
        jc = dataclasses.replace(_FUSED_CFG[0], dtype=dtype)
        akv, q_row, q_abs, w, kc, ks, lengths = _fused_mla_inputs(variant,
                                                                  s0)
        dt = getattr(jnp, dtype)
        ckv, q_pe = _split(jnp.asarray(akv).astype(dt),
                           None if q_row is None
                           else jnp.asarray(q_row).astype(dt), jc)
        q_abs = jnp.asarray(q_abs).astype(dt).transpose(1, 2, 0, 3)
        q_eff, lat = _jit_fused_rows(ckv, q_pe, q_abs, jnp.asarray(w),
                                     jnp.asarray(lengths), cfg=jc)
        k_q, k_s = jllama.quantize_kv(lat)
        res = _jit_insert(jnp.asarray(kc), jnp.asarray(ks), k_q, k_s,
                          jnp.asarray(lengths), jnp.int32(2), jnp.int32(s0))
        out[variant, dtype, s0] = [np.asarray(q_eff[:, 0], np.float32),
                                   *[np.asarray(a) for a in res]]
    return out


@pytest.mark.parametrize("variant,dtype", sorted({c[:2] for c in _FUSED_MLA}))
def test_mla_fused_insert_matches_jax(jax_fused_mla, variant, dtype):
    """The fused latent insert on the CPU (its plain version: the port's
    ``rmsnorm``, interleaved yarn ``rope_apply``, cat and pad,
    ``quantize_kv`` and the codes-in insert) against the JAX chain, with
    ckv and q_pe strided views of the projection rows and q_abs strided as
    the einsum leaves it: q_eff within 1e-5 in float32 (the rope
    tolerance above: cos/sin of one float32 angle in two libraries) and
    within one bfloat16 step (2**-7 of |q| plus 1e-5) in bfloat16, its
    q_abs lanes and zero pad exact, for every slot; the written latent
    codes within one step of JAX's in at most 0.1% of them (the rounding
    ties of ``_check_chain``), scales within 1e-5 relative, every entry
    not written untouched. Each case runs at both cache offsets s0."""
    for s0 in sorted({c[2] for c in _FUSED_MLA}):
        _check_fused_insert(jax_fused_mla[variant, dtype, s0], variant,
                            dtype, s0)


def _check_fused_insert(jax_res, variant, dtype, s0):
    ref_q, ref_kc, ref_ks = jax_res
    tc = _FUSED_CFG[1]
    akv, q_row, q_abs, w, kc, ks, lengths = _fused_mla_inputs(variant, s0)
    dt = getattr(torch, dtype)
    ckv, q_pe = _split(torch.from_numpy(akv).to(dt),
                       None if q_row is None
                       else torch.from_numpy(q_row).to(dt), tc)
    qa = torch.from_numpy(q_abs).to(dt).permute(1, 2, 0, 3)
    assert not (ckv.is_contiguous() or q_pe.is_contiguous()
                or qa.is_contiguous())
    ln = torch.from_numpy(lengths)
    rope = tllama._rope_tables(ln[:, None], tc.rope_theta,
                               tc.qk_rope_head_dim, tc)
    opts = dict(tllama._rope_options(tc), eps=tc.norm_eps)
    tw = torch.from_numpy(w)
    got_c = [torch.from_numpy(a.copy()) for a in (kc, ks)]
    plain_c = [torch.from_numpy(a.copy()) for a in (kc, ks)]
    got = mla_cache_insert_int8_fused(ckv, q_pe, qa, tw, *rope, *got_c, ln,
                                      2, s0, **opts)
    plain = mla_cache_insert_int8_fused_reference(ckv, q_pe, qa, tw, *rope,
                                                  *plain_c, ln, 2, s0,
                                                  **opts)
    # the CPU dispatch is the plain version
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(got_c, plain_c))
    r, dr = tc.kv_lora_rank, tc.qk_rope_head_dim
    assert got.dtype == dt and got.shape == (4, tc.n_heads,
                                             tc.mla_cache_dim)
    g = got.float().numpy()
    np.testing.assert_array_equal(g[..., :r], ref_q[..., :r])
    assert not g[..., r + dr:].any() and not ref_q[..., r + dr:].any()
    if dtype == "float32":
        assert np.max(np.abs(g - ref_q)) <= 1e-5
    else:
        assert np.all(np.abs(g - ref_q) <= 2.0 ** -7 * np.abs(ref_q) + 1e-5)
    rows = np.zeros(ks.shape, bool)                     # [L, B, 1, S]
    for b, n in enumerate(lengths):
        if 0 <= n - s0 < rows.shape[3]:
            rows[2, b, 0, n - s0] = True
    assert rows.sum() == (2 if s0 else 3)
    t_kc, t_ks = (a.numpy() for a in got_c)
    for t_a, j_a, a in ((t_kc, ref_kc, kc), (t_ks, ref_ks, ks)):
        np.testing.assert_array_equal(t_a[~rows], a[~rows])
        np.testing.assert_array_equal(j_a[~rows], a[~rows])
    d = np.abs(t_kc[rows].astype(np.int32) - ref_kc[rows].astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, np.sum(d > 0)
    assert not t_kc[rows][:, tc.mla_kv_dim:].any()
    np.testing.assert_allclose(t_ks[rows], ref_ks[rows], rtol=1e-5, atol=0)


# ── forward ─────────────────────────────────────────────────────────────

_FWD = {"mla-float32": ("test-tiny-mla", "float32", 3),
        "dsv3-float32": ("test-tiny-dsv3", "float32", 3),
        "mla-bfloat16": ("test-tiny-mla", "bfloat16", 5)}
_N_DECODE = 3


def _fwd_inputs(vocab):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, vocab, (2, 12)).astype(np.int32)
    steps = [rng.integers(0, vocab, (2, 1)).astype(np.int32)
             for _ in range(_N_DECODE)]
    return prompt, steps


def _host(cache):
    return jax.tree.map(np.asarray, cache)


# one trace per config and shape (eager, each step took as long as a trace)
_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def jax_params():
    """name -> the JAX params of each forward config (one init each, shared
    by the forward and engine runs)."""
    return {name: jllama.init_params(_configs(preset, dtype)[0], seed=seed)
            for name, (preset, dtype, seed) in _FWD.items()}


@pytest.fixture(scope="module")
def jax_forward(jax_params):
    """name -> (flat params, {"xla": (logits per call, cache),
    "pallas_interpret": (decode logits, cache)}); the Pallas chain decodes
    from the "xla" chain's prefilled cache (float32 configs only)."""
    out = {}
    for name, (preset, dtype, seed) in _FWD.items():
        jc, _ = _configs(preset, dtype)
        jp = jax_params[name]
        prompt, steps = _fwd_inputs(jc.vocab_size)
        lg, cache = _jit_forward(jp, jnp.asarray(prompt),
                                 jllama.init_cache(jc, 2, 64), cfg=jc)
        prefilled, runs = cache, {}
        outs = [np.asarray(lg, np.float32)]
        for tok in steps:
            lg, cache = _jit_forward(jp, jnp.asarray(tok), cache, cfg=jc)
            outs.append(np.asarray(lg, np.float32))
        runs["xla"] = (outs, _host(cache))
        if dtype == "float32":
            jpl = dataclasses.replace(jc, kernel_mode="pallas_interpret")
            cache, outs = prefilled, []
            for tok in steps:
                lg, cache = _jit_forward(jp, jnp.asarray(tok), cache,
                                         cfg=jpl)
                outs.append(np.asarray(lg, np.float32))
            runs["pallas_interpret"] = (outs, _host(cache))
        out[name] = (_flat(jp), runs)
    return out


def _selection_margin(x: torch.Tensor, router: torch.Tensor, bias,
                      cfg) -> float:
    """Smallest gap, in float64, between the k-th and (k+1)-th selection
    score and between the last group kept and the best group dropped."""
    logits = x.double().reshape(-1, x.shape[-1]) @ router.double()
    probs = (torch.sigmoid(logits) if cfg.score_fn == "sigmoid"
             else torch.softmax(logits, dim=-1))
    sel = probs if bias is None else probs + bias.double()
    margin = float("inf")
    if cfg.n_expert_groups:
        gsel = sel.reshape(len(sel), cfg.n_expert_groups, -1)
        srt = gsel.sort(dim=-1, descending=True).values
        gscore = (srt[..., :2].sum(-1) if cfg.group_score == "top2sum"
                  else srt[..., 0])
        gs, order = gscore.sort(dim=-1, descending=True)
        g = cfg.topk_groups
        margin = float((gs[:, g - 1] - gs[:, g]).min())
        keep = torch.zeros_like(gscore, dtype=torch.bool).scatter_(
            -1, order[:, :g], True)
        sel = torch.where(keep[..., None], gsel,
                          torch.zeros_like(gsel)).reshape(len(sel), -1)
    s = sel.sort(dim=-1, descending=True).values
    k = cfg.experts_per_token
    return min(margin, float((s[:, k - 1] - s[:, k]).min()))


@pytest.fixture
def routing_margins(monkeypatch):
    """The smallest selection margin over every ``moe_route`` call the port
    makes."""
    seen = []
    inner = tllama.moe_route

    def route(x, router, cfg, bias=None):
        seen.append(_selection_margin(x, router, bias, cfg))
        return inner(x, router, cfg, bias)
    monkeypatch.setattr(tllama, "moe_route", route)
    return seen


def _port_run(tparams, tc, tokens, cache=None):
    cache = cache or tllama.init_cache(tc, 2, 64, "cpu")
    outs = []
    for tok in tokens:
        lg, cache = tllama.forward(tparams, torch.from_numpy(tok), cache, tc,
                                   device="cpu")
        outs.append(lg.float().numpy())
    return outs, cache


def _check_chain(ref, got, jcache, tcache, f32: bool, pos0: int, what):
    """Logits per call and the latent cache, with the rounding-tie rule."""
    if f32:
        diff = (jcache.k_codes != tcache.k_codes.numpy()).any(axis=(0, 2, 4))
        tainted = np.cumsum(diff, axis=1) > 0              # [B, S]
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
        tol = (np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
               if f32 else 3e-2)
        assert np.all(err <= tol), (what, err)
        pos0 += r.shape[1]
    np.testing.assert_array_equal(tcache.lengths.numpy(), jcache.lengths)
    assert tcache.v_codes.shape[-1] == 0 and jcache.v_codes.shape[-1] == 0
    if not f32:
        return
    d = np.abs(jcache.k_codes.astype(np.int32)
               - tcache.k_codes.numpy().astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, what
    np.testing.assert_allclose(tcache.k_scale.numpy(), jcache.k_scale,
                               rtol=1e-5, atol=0)
    jl = jcache.k_codes * jcache.k_scale[..., None]
    tl = tcache.k_codes.numpy() * tcache.k_scale.numpy()[..., None]
    assert np.max(np.abs(jl - tl)) <= 2e-3 * np.max(np.abs(jl)), what


@pytest.mark.parametrize("name", list(_FWD))
def test_mla_forward_matches_jax(jax_forward, routing_margins, name):
    preset, dtype, _ = _FWD[name]
    jc, tc = _configs(preset, dtype)
    flat, runs = jax_forward[name]
    tparams = params_from_flat(flat, tc, "cpu")
    assert (tparams.layers0 is not None) == bool(jc.first_k_dense)
    prompt, steps = _fwd_inputs(jc.vocab_size)
    f32 = dtype == "float32"
    ref, jcache = runs["xla"]
    for mode in ("xla", "auto"):
        tcm = dataclasses.replace(tc, kernel_mode=mode)
        prefill, tcache = _port_run(tparams, tcm, [prompt])
        after = tllama.KVCache(*[t.clone() for t in (
            tcache.k_codes, tcache.k_scale, tcache.v_codes, tcache.v_scale,
            tcache.lengths)])
        decode, tcache = _port_run(tparams, tcm, steps, tcache)
        _check_chain(ref, prefill + decode, jcache, tcache, f32, 0, mode)
        if f32 and mode == "auto":
            # the kernel pair against the JAX package's Pallas pair
            pref, pcache = runs["pallas_interpret"]
            decode, tcache = _port_run(tparams, tcm, steps, after)
            _check_chain(pref, decode, pcache, tcache, True, 12,
                         "pallas_interpret")
    if jc.n_experts:
        assert min(routing_margins) >= 1e-5


def test_mla_kernel_mode_takes_the_mla_pair(jax_forward, monkeypatch):
    """Decode in kernel mode calls the fused MLA insert (RMSNorm, RoPE,
    quantization, insert and q_eff) and the MLA flash decode once per layer
    (the dense prefix's included), prefill never; the unfused latent chain
    (``mla_latent_rows``) runs at prefill only; the GQA pair (the fused
    RoPE + quantize + insert entry and its flash decode) is never
    called."""
    jc, tc = _configs("test-tiny-dsv3")
    tparams = params_from_flat(jax_forward["dsv3-float32"][0], tc, "cpu")
    calls = []
    # each wrapper's position of the layer argument, as the forward calls it
    at = {"mla_cache_insert_int8_fused": 9, "mla_flash_decode_int8": 4,
          "cache_insert_int8_fused": 10, "flash_decode_int8": 6,
          "mla_latent_rows": None}
    for name, i in at.items():
        def spy(*a, _n=name, _i=i, _f=getattr(tllama, name), **kw):
            calls.append((_n, None if _i is None else a[_i]))
            return _f(*a, **kw)
        monkeypatch.setattr(tllama, name, spy)
    prompt, steps = _fwd_inputs(jc.vocab_size)
    tcm = dataclasses.replace(tc, kernel_mode="auto")
    _, cache = _port_run(tparams, tcm, [prompt])
    assert calls == [("mla_latent_rows", None)] * jc.n_layers
    calls.clear()
    _port_run(tparams, tcm, steps[:1], cache)
    assert calls == [(n, layer) for layer in range(jc.n_layers)
                     for n in ("mla_cache_insert_int8_fused",
                               "mla_flash_decode_int8")]


def test_mla_init_params_structure():
    """The port's own random DeepSeek weights: the dense-prefix stack, the
    MoE stack of n_layers - first_k_dense rows addressed with its own depth
    as the expert stride, the shared experts, the bias and the MLA fields;
    a kernel-mode forward is finite."""
    _, tc = _configs("test-tiny-dsv3")
    p = tllama.init_params(tc, seed=0, device="cpu")
    lay, lay0 = p.layers, p.layers0
    assert lay.attn_norm.shape[0] == 2 and lay0.attn_norm.shape[0] == 1
    assert tuple(lay.we_gate_up.codes.shape[:2]) == (8, 2)
    assert tuple(lay.we_down.codes.shape[1:]) == (2, 512, 256)  # K 128 -> 1024
    assert lay.ws_gate_up.shape == (256, 512) and lay.ws_down.shape == (256,
                                                                        256)
    assert tuple(lay.router_bias.shape) == (2, 8)
    assert lay0.w_gate_up.shape == (256, 1024) and lay0.router is None
    assert lay.wqkv.shape == (256, 64 + 64 + 16)
    assert lay.w_q_b.shape == (64, 4 * 48)
    assert tuple(lay.w_uk.shape) == (2, 4, 32, 64)
    assert lay.w_uk.dtype == torch.float32
    assert tuple(lay.w_uv.shape) == (2, 4, 64, 32)
    cache = tllama.init_cache(tc, 1, 16, "cpu")
    assert tuple(cache.k_codes.shape) == (3, 1, 1, 16, 128)
    assert tuple(cache.v_scale.shape) == (3, 1, 0, 16)
    lg, cache = tllama.forward(p, [[1, 2, 3]], cache,
                               dataclasses.replace(tc, kernel_mode="auto"),
                               device="cpu")
    lg, cache = tllama.forward(p, [[4]], cache,
                               dataclasses.replace(tc, kernel_mode="auto"),
                               device="cpu")
    assert torch.isfinite(lg).all()
    assert cache.k_scale[:, 0, 0, :4].all() and not cache.k_scale[:, 0, 0,
                                                                   4:].any()


# ── engine, checkpoint ──────────────────────────────────────────────────


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(3, vocab, n)] for n in (5, 11, 3)]


def _drive(eng, make_req, vocab):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts(vocab))]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


_ENGINE = dict(max_slots=2, max_seq=64, eos_id=-1)


@pytest.fixture(scope="module")
def jax_engine(jax_params):
    """preset -> (flat params, the JAX Engine's greedy streams), on the
    float32 forward runs' parameters."""
    out = {}
    for preset, name in (("test-tiny-mla", "mla-float32"),
                         ("test-tiny-dsv3", "dsv3-float32")):
        jc, _ = _configs(preset)
        out[preset] = _drive(JEngine(jax_params[name], jc, **_ENGINE),
                             JRequest, jc.vocab_size)
    return out


@pytest.mark.parametrize("preset,name", [("test-tiny-mla", "mla-float32"),
                                         ("test-tiny-dsv3", "dsv3-float32")])
def test_mla_engine_matches_jax(jax_forward, jax_engine, preset, name):
    _, tc = _configs(preset, kernel_mode="auto")
    eng = TEngine(params_from_flat(jax_forward[name][0], tc, "cpu"), tc,
                  device="cpu", **_ENGINE)
    got = _drive(eng, TRequest, tc.vocab_size)
    assert got == jax_engine[preset]
    assert all(len(o) == 6 for o in got)


def _np(a):
    """numpy of a leaf; bfloat16 as its raw 16-bit words."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()


def _leaves(flat):
    return {name: [_np(p) for p in ([leaf.codes, leaf.scales]
                                    if hasattr(leaf, "codes") else [leaf])]
            for name, leaf in flat.items()}


def test_dsv3_checkpoint_round_trips_both_ways(tmp_path):
    jc = JPRESETS["test-tiny-dsv3"]
    jp = jllama.init_params(jc, seed=1)
    jflat = _leaves(_flat(jp))
    assert {"layers0.0.w_gate_up", "layers.1.ws_down", "layers.0.w_q_b",
            "layers.1.router_bias", "layers.0.we_down.7",
            "layers0.0.kv_a_norm"} <= jflat.keys()
    j_save(tmp_path / "j", jp, jc)
    tparams, cfg = t_load(tmp_path / "j", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    tflat = _leaves(flat_from_params(tparams))
    assert list(tflat) == list(_flatten_params(jp))      # the writer's order
    for name in jflat:
        for a, b in zip(tflat[name], jflat[name]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    t_save(tmp_path / "t", tparams, cfg)
    assert ((tmp_path / "t" / "data.bin").read_bytes()
            == (tmp_path / "j" / "data.bin").read_bytes())
