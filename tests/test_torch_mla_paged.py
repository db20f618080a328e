"""The port's paged MLA latent pool against the JAX package (CPU, float32).

Every JAX result comes from one module-scoped run (``jax_runs``), on numpy
inputs made from seeded generators; JAX parameters are carried across with
``params_from_flat``. Configs: ``test-tiny-mla`` (direct q, dense MLP) and
``test-tiny-dsv3`` (low-rank q, MoE with shared experts, a dense-prefix
layer).

* The fused latent insert's plain version given a page table
  (``mla_cache_insert_int8_fused`` on the CPU) against the JAX chain
  (``rmsnorm``, ``_rope``, concatenate and pad, ``quantize_kv``,
  ``_paged_insert_at_layer``): the pool's codes byte-equal and its scales
  within 1e-5 relative (the two libraries' absmax / 127 part in the last
  bit on some rows), entries not written unchanged, q_eff within 1e-5 (cos
  and sin of one float32 angle in two libraries). The paged latent decode's
  plain version (``mla_flash_decode_int8`` on the CPU) against JAX's
  ``paged_gather`` then ``attention``: within 1e-4, the tolerance of
  ``test_torch_mla.py``'s ``test_mla_flash_decode_matches_jax``. Both at
  pages of 8 and 16 under a shuffled table whose entries past each slot's
  pages point at the scratch page 0, with lengths on both sides of page
  edges, a slot at capacity (its insert dropped) and a slot of length 0
  (its insert on page 0 of its row; its decode output zeros in the port,
  whereas JAX's softmax over no visible key averages every row, so that
  slot is held to zeros and not to JAX).
* ``forward`` over a latent pool against JAX's paged ``forward``: a
  12-token prefill (across pages of 8) and 2 decode steps through the same
  shuffled table, in the port's plain mode ("xla") and kernel mode ("auto":
  the decode takes the fused insert and the paged decode with the table),
  with ``test_torch_mla.py``'s tolerances and its rounding-tie rule for the
  latent codes.
* Greedy engine streams over the pool, contiguous in each slot's table or
  prefix-cached (pages of 16: 32 shared tokens, hit by each later request)
  or oversubscribed (9 pages of 8, preempting), token-identical to the JAX
  ``Engine``'s (its contiguous cache, as ``test_torch_mla.py`` runs it),
  the prefix hits equal to their count by construction, and every page
  free or cached at the end.
* ``python -m quant_tpu_torch serve --paged --prefix-cache --device cpu``
  on an MLA checkpoint answers ``/generate`` with the JAX engine's tokens.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.paged_attention import paged_gather as j_gather
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.kernels.cache_insert import mla_cache_insert_int8_fused
from quant_tpu_torch.kernels.mla_attention import (
    mla_flash_decode_int8, mla_flash_decode_int8_reference)
from quant_tpu_torch.kernels.paged_attention import paged_gather
from quant_tpu_torch.models import PRESETS as TPRESETS
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

REPO = pathlib.Path(__file__).resolve().parents[1]
PRESETS = ("test-tiny-mla", "test-tiny-dsv3")
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(preset, **kw):
    jc = dataclasses.replace(JPRESETS[preset], dtype="float32", **kw)
    return jc, TConfig(**dataclasses.asdict(jc))


def _table(rng, b, max_pages, used):
    """A pool of ``1 + b * max_pages`` pages and a shuffled table: slot i
    owns ``used[i]`` pages, its other entries on the scratch page 0."""
    n_pool = 1 + b * max_pages
    perm = rng.permutation(np.arange(1, n_pool))
    tbl = np.zeros((b, max_pages), np.int32)
    for i, u in enumerate(used):
        tbl[i, :u] = perm[i * max_pages:i * max_pages + u]
    return n_pool, tbl


# ── (a) the insert and the decode over a pool ───────────────────────────

_LAYERS, _MAX_SEQ = 2, 64
# insert positions: 0 (page 0 of a slot), the last row of a page of 8, the
# first row of page 2 (of page 1 at 16), inside a page, at capacity
_INSERT_AT = [0, 7, 16, 37, 64]
# decode lengths: an empty slot, each side of a page edge, a full slot
_DECODE_LEN = [0, 8, 17, 38, 64]


def _pool_inputs(page):
    """Numpy inputs of one page size: the projection rows (ckv, q_pe,
    q_abs), the RMSNorm gain, a latent pool of random codes and scales, the
    table and the decode query."""
    jc, _ = _configs("test-tiny-mla")
    rng = np.random.default_rng(page)
    b, h = len(_INSERT_AT), jc.n_heads
    r, dr, dq = jc.kv_lora_rank, jc.qk_rope_head_dim, jc.mla_cache_dim
    max_pages = _MAX_SEQ // page
    used = [min(max_pages, n // page + 1) for n in _INSERT_AT]
    n_pool, tbl = _table(rng, b, max_pages, used)
    kf = rng.standard_normal((_LAYERS, n_pool, 1, page, dq)).astype(
        np.float32)
    ks = (np.abs(kf).max(-1) / 127.0).astype(np.float32)
    kc = np.round(kf / ks[..., None]).astype(np.int8)
    return dict(
        ckv=rng.standard_normal((b, 1, r + dr), dtype=np.float32),
        q_pe=rng.standard_normal((b, 1, h, dr), dtype=np.float32),
        q_abs=rng.standard_normal((b, 1, h, r), dtype=np.float32),
        w=(1.0 + 0.1 * rng.standard_normal(r)).astype(np.float32),
        kc=kc, ks=ks, tbl=tbl,
        q=rng.standard_normal((b, h, dq)).astype(np.float32))


def _j_rows(ckv, q_pe, q_abs, w, pos, cfg):
    """The JAX forward's latent rows: ``rmsnorm`` of c, ``_rope`` of q_pe
    and k_pe, concatenate and pad: (q_eff, lat)."""
    r = cfg.kv_lora_rank
    c = jllama.rmsnorm(ckv[..., :r], w, cfg.norm_eps)
    q_pe = jllama._rope(q_pe, pos[:, None], cfg.rope_theta, cfg)
    k_pe = jllama._rope(ckv[..., r:][:, :, None, :], pos[:, None],
                        cfg.rope_theta, cfg)
    pad = ((0, 0), (0, 0), (0, 0), (0, cfg.mla_cache_dim - cfg.mla_kv_dim))
    q_eff = jnp.pad(jnp.concatenate([q_abs, q_pe], -1), pad)
    lat = jnp.pad(jnp.concatenate([c, k_pe[:, :, 0]], -1)[:, :, None, :],
                  pad)
    return q_eff, lat


def _j_insert_decode(kc, ks, k_q, k_s, pos, tbl, q, lengths, cfg):
    """``_paged_insert_at_layer`` at layer 1, then ``paged_gather`` and
    ``attention`` over layer 1 of the pool it left."""
    r = cfg.kv_lora_rank
    kc, ks = jllama._paged_insert_at_layer(kc, ks, k_q, k_s, pos, 1, tbl)
    kcl, ksl = j_gather(kc, tbl, 1), j_gather(ks, tbl, 1)
    out = jllama.attention(q[:, None], kcl, ksl, kcl[..., :r], ksl,
                           lengths[:, None] - 1, lengths, cfg)
    return kc, ks, out[:, 0]


def _j_pool_case(page):
    """The JAX chain's q_eff and pool after the insert at layer 1, and its
    decode over layer 1: the rows and the insert with the decode jitted,
    ``quantize_kv`` eagerly between them, as ``test_torch_mla.py`` runs it
    (under ``jax.jit`` XLA may divide by another rounding of the scale)."""
    jc, _ = _configs("test-tiny-mla")
    x = {k: jnp.asarray(v) for k, v in _pool_inputs(page).items()}
    pos = jnp.asarray(_INSERT_AT, jnp.int32)
    q_eff, lat = _jit_rows(x["ckv"], x["q_pe"], x["q_abs"], x["w"], pos,
                           cfg=jc)
    k_q, k_s = jllama.quantize_kv(lat)
    res = _jit_insert_decode(x["kc"], x["ks"], k_q, k_s, pos, x["tbl"],
                             x["q"], jnp.asarray(_DECODE_LEN, jnp.int32),
                             cfg=jc)
    return (np.asarray(q_eff[:, 0]), *[np.asarray(a) for a in res],
            jllama._q_scale(jc, jc.mla_cache_dim))


# ── (b) forward over a pool ─────────────────────────────────────────────

_FWD_B, _FWD_T, _FWD_PAGE, _N_DECODE = 2, 12, 8, 2


def _fwd_inputs(vocab):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, vocab, (_FWD_B, _FWD_T)).astype(np.int32)
    steps = [rng.integers(0, vocab, (_FWD_B, 1)).astype(np.int32)
             for _ in range(_N_DECODE)]
    max_pages = _MAX_SEQ // _FWD_PAGE
    n_pool, tbl = _table(np.random.default_rng(8), _FWD_B, max_pages,
                         [max_pages] * _FWD_B)
    return prompt, steps, n_pool, tbl


# ── (c) engines ─────────────────────────────────────────────────────────

_PAGE = 16
_SHARED = 2 * _PAGE          # two full blocks every prompt shares
_N_NEW = 6
_ENGINE = dict(max_slots=2, max_seq=_MAX_SEQ, eos_id=-1)
_PORT_ENGINES = {"paged": dict(paged=True, page_size=8),
                 "prefix": dict(paged=True, page_size=_PAGE,
                                prefix_cache=True),
                 "oversubscribed": dict(paged=True, page_size=8, n_pages=9)}


def _engine_prompts(vocab):
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(3, vocab, _SHARED)]
    return [shared + [int(t) for t in rng.integers(3, vocab, n)]
            for n in (4, 9, 1)]


def _drive(eng, make_req, prompts):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=_N_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs], eng.stats


# one trace per config and shape
_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))
_jit_rows = jax.jit(_j_rows, static_argnames=("cfg",))
_jit_insert_decode = jax.jit(_j_insert_decode, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's results: per page size the insert and decode of
    (a); per preset the flat parameters, the paged forward's logits and
    pool (b), and the engine's greedy streams (c), from its contiguous
    cache as ``test_torch_mla.py``'s ``jax_engine`` runs it."""
    out = {"pool": {page: _j_pool_case(page) for page in (8, 16)}}
    for preset in PRESETS:
        jc, _ = _configs(preset)
        jp = jllama.init_params(jc, seed=SEED)
        prompt, steps, n_pool, tbl = _fwd_inputs(jc.vocab_size)
        cache = dataclasses.replace(
            jllama.init_paged_cache(jc, _FWD_B, _MAX_SEQ, n_pool, _FWD_PAGE),
            page_tbl=jnp.asarray(tbl))
        logits = []
        for toks in [prompt] + steps:
            lg, cache = _jit_forward(jp, jnp.asarray(toks), cache, cfg=jc)
            logits.append(np.asarray(lg, np.float32))
        eng = JEngine(jp, jc, **_ENGINE)
        out[preset] = dict(
            flat=_flatten_params(jax.tree.map(np.asarray, jp)),
            logits=logits, pool=jax.tree.map(np.asarray, cache),
            engine=_drive(eng, JRequest, _engine_prompts(jc.vocab_size)))
    return out


@pytest.mark.parametrize("page", [8, 16])
def test_paged_mla_insert_matches_jax(jax_runs, page):
    """The fused latent insert's plain version through a shuffled table:
    the pool's codes byte-equal to JAX's and its scales within 1e-5
    relative, q_eff within 1e-5 for every slot; the slot at capacity
    writes nothing, the others one row each, and nothing else changes."""
    ref_q, ref_kc, ref_ks, _, _ = jax_runs["pool"][page]
    _, tc = _configs("test-tiny-mla")
    x = _pool_inputs(page)
    ln = torch.tensor(_INSERT_AT, dtype=torch.int32)
    rope = tllama._rope_tables(ln[:, None], tc.rope_theta,
                               tc.qk_rope_head_dim, tc)
    kc, ks = torch.from_numpy(x["kc"].copy()), torch.from_numpy(
        x["ks"].copy())
    q_eff = mla_cache_insert_int8_fused(
        *(torch.from_numpy(x[k]) for k in ("ckv", "q_pe", "q_abs", "w")),
        *rope, kc, ks, ln, 1, eps=tc.norm_eps,
        page_tbl=torch.from_numpy(x["tbl"]), **tllama._rope_options(tc))
    assert q_eff.shape == (len(_INSERT_AT), tc.n_heads, tc.mla_cache_dim)
    assert np.max(np.abs(q_eff.numpy() - ref_q)) <= 1e-5
    assert kc.numpy().tobytes() == ref_kc.tobytes()
    np.testing.assert_allclose(ks.numpy(), ref_ks, rtol=1e-5, atol=0)
    changed = ks.numpy() != x["ks"]
    assert changed.sum() == len(_INSERT_AT) - 1
    np.testing.assert_array_equal(ref_ks[~changed], x["ks"][~changed])


@pytest.mark.parametrize("page", [8, 16])
def test_paged_mla_decode_matches_jax(jax_runs, page):
    """The paged latent decode's plain version (the CPU dispatch of
    ``mla_flash_decode_int8`` with a table) against JAX's gather and
    attention over the pool the insert left: within 1e-4; the empty slot
    gives zeros; the same as the contiguous plain version over the
    gathered rows."""
    _, ref_kc, ref_ks, ref_out, scale = jax_runs["pool"][page]
    _, tc = _configs("test-tiny-mla")
    x = _pool_inputs(page)
    r = tc.kv_lora_rank
    kc, ks = (torch.from_numpy(a.copy()) for a in (ref_kc, ref_ks))
    tbl = torch.from_numpy(x["tbl"])
    ln = torch.tensor(_DECODE_LEN, dtype=torch.int32)
    q = torch.from_numpy(x["q"])
    got = mla_flash_decode_int8(q, kc, ks, ln, 1, r=r, scale=scale,
                                page_tbl=tbl)
    assert got.shape == (len(_DECODE_LEN), tc.n_heads, r)
    np.testing.assert_allclose(got[1:].numpy(), ref_out[1:], rtol=1e-4,
                               atol=1e-4)
    assert not got[0].any()
    rows = paged_gather(kc, tbl, 1), paged_gather(ks, tbl, 1)
    assert torch.equal(got, mla_flash_decode_int8_reference(
        q, *rows, ln, r=r, scale=scale))


def test_paged_mla_pool_layout():
    """The latent pool of a DeepSeek config: one row of ``mla_cache_dim``
    lanes a token, zero-width V, the table sized for ``max_seq``; a
    ``max_seq`` the page does not divide raises."""
    for preset, dq in (("test-tiny-mla", 128), ("deepseek-v2-lite", 640),
                       ("deepseek-v3", 640)):
        cfg = TPRESETS[preset]
        cfg = dataclasses.replace(cfg, n_layers=cfg.first_k_dense + 2)
        n = cfg.n_layers
        c = tllama.init_paged_cache(cfg, 3, 256, n_pages=5, page=128,
                                    device="cpu")
        assert tuple(c.k_codes.shape) == (n, 5, 1, 128, dq)
        assert tuple(c.k_scale.shape) == (n, 5, 1, 128)
        assert tuple(c.v_codes.shape) == (n, 5, 1, 128, 0)
        assert tuple(c.v_scale.shape) == (n, 5, 0, 128)
        assert tuple(c.page_tbl.shape) == (3, 2)
        assert c.k_codes.dtype == torch.int8
        with pytest.raises(ValueError, match="divide"):
            tllama.init_paged_cache(cfg, 3, 200, n_pages=5, page=128,
                                    device="cpu")


def _gather_slots(pool, tbl):
    """[L, P, 1, page(, D)] pool -> slot-contiguous [L, B, 1, S(, D)]."""
    g = np.moveaxis(pool[:, tbl], 3, 2)       # [L, B, 1, n, page(, D)]
    return g.reshape(*g.shape[:3], -1, *g.shape[5:])


@pytest.mark.parametrize("preset", PRESETS)
def test_paged_mla_forward_matches_jax(jax_runs, preset):
    """Logits within 1e-4 of max|logit| (1e-3 from a slot's first latent
    code that differs by one rounding step), latent codes within one step
    in at most 0.1% of the pool, scales within 1e-5 relative, the
    dequantized latent within 2e-3 of its max; in "xla" and "auto"."""
    _, tc = _configs(preset)
    ref = jax_runs[preset]
    tparams = params_from_flat(ref["flat"], tc, "cpu")
    prompt, steps, n_pool, tbl = _fwd_inputs(tc.vocab_size)
    jp = ref["pool"]
    for mode in ("xla", "auto"):
        tcm = dataclasses.replace(tc, kernel_mode=mode)
        cache = tllama.init_paged_cache(tcm, _FWD_B, _MAX_SEQ, n_pool,
                                        _FWD_PAGE, device="cpu")
        cache.page_tbl.copy_(torch.from_numpy(tbl))
        got = []
        for toks in [prompt] + steps:
            lg, cache = tllama.forward(tparams, torch.from_numpy(toks),
                                       cache, tcm, device="cpu")
            got.append(lg.numpy())
        assert isinstance(cache, tllama.PagedKVCache)
        np.testing.assert_array_equal(cache.lengths.numpy(), jp.lengths)
        assert cache.v_codes.shape[-1] == 0 == jp.v_codes.shape[-1]
        tkc, tks = cache.k_codes.numpy(), cache.k_scale.numpy()
        d = np.abs(jp.k_codes.astype(np.int32) - tkc.astype(np.int32))
        assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (mode, d.max())
        np.testing.assert_allclose(tks, jp.k_scale, rtol=1e-5, atol=0)
        jl = jp.k_codes * jp.k_scale[..., None]
        assert np.max(np.abs(jl - tkc * tks[..., None])) <= 2e-3 * np.max(
            np.abs(jl)), mode
        diff = (_gather_slots(d, tbl) > 0).any(axis=(0, 2, 4))     # [B, S]
        tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref["logits"], got):
            assert r.shape == g.shape
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
            assert np.all(err <= tol), (mode, err)
            pos0 += r.shape[1]


def _pages_accounted(stats):
    return (stats["free_pages"] + stats.get("cached_blocks", 0)
            == stats["total_pages"])


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", list(_PORT_ENGINES))
def test_paged_mla_engine_matches_jax(jax_runs, preset, kind):
    """Greedy streams equal to the JAX engine's; with prefix caching the
    hits are the 32 shared tokens of each request after the first; the
    oversubscribed pool preempts and resumes; every page free or cached
    after the drain."""
    _, tc = _configs(preset, kernel_mode="auto")
    ref = jax_runs[preset]
    j_outs, _ = ref["engine"]
    eng = TEngine(params_from_flat(ref["flat"], tc, "cpu"), tc,
                  device="cpu", **_ENGINE, **_PORT_ENGINES[kind])
    preempted = []
    inner = eng._preempt_newest

    def counted():
        preempted.append(1)
        return inner()
    eng._preempt_newest = counted
    prompts = _engine_prompts(tc.vocab_size)
    outs, stats = _drive(eng, TRequest, prompts)
    assert outs == j_outs and all(len(o) == _N_NEW for o in outs)
    assert _pages_accounted(stats)
    if kind == "prefix":
        assert stats["prefix_hit_tokens"] == _SHARED * (len(prompts) - 1)
    else:
        assert stats["free_pages"] == stats["total_pages"]
    assert bool(preempted) == (kind == "oversubscribed")


def test_cli_serve_paged_prefix_cache_mla(tmp_path, jax_runs):
    """``serve --paged --prefix-cache`` on a test-tiny-mla checkpoint
    answers ``/generate`` with the JAX engine's tokens for the prompt."""
    _, tc = _configs("test-tiny-mla")
    ref = jax_runs["test-tiny-mla"]
    t_save(tmp_path / "ckpt", params_from_flat(ref["flat"], tc, "cpu"), tc)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "quant_tpu_torch", "serve",
         str(tmp_path / "ckpt"), "--port", str(port), "--paged",
         "--page-size", str(_PAGE), "--prefix-cache", "--slots", "2",
         "--max-seq", str(_MAX_SEQ), "--eos-id", "-1", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    prompt = _engine_prompts(tc.vocab_size)[0]
    try:
        t0 = time.time()
        while True:
            try:
                with opener.open(base + "/healthz", timeout=10) as resp:
                    assert json.loads(resp.read())["ok"]
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.time() - t0 < 120
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/generate", json.dumps(
                {"prompt_ids": prompt, "max_new_tokens": _N_NEW}).encode(),
            {"Content-Type": "application/json"})
        with opener.open(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["output_ids"] == ref["engine"][0][0]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
