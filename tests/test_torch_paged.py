"""The port's paged KV pool against the JAX package (CPU, test-tiny, float32).

* Paged flash decode: the port's wrapper (its plain version on the CPU)
  against ``paged_flash_decode_int8(interpret=True)`` and
  ``paged_attention_reference``, atol/rtol 2e-5 (the JAX package's own
  tolerance), pages 8 and 16, lengths 0 to a full slot. A slot of length 0
  gives zeros in both kernels; the JAX reference averages it uniformly, so
  only slots with a length are held against it.
* Paged insert: the codes-in plain version
  ``paged_cache_insert_int8_reference`` (which the fused insert's plain
  version runs after RoPE and quantization) byte-equal to
  ``llama._paged_insert_at_layer`` and
  ``paged_cache_insert_int8(interpret=True)``, with a position at the
  table's capacity (skipped) and a parked slot (length 0, table row 0).
* ``forward`` over a ``PagedKVCache`` against the JAX paged forward
  (``kernel_mode="xla"``): prefill, then 3 decode steps, with the
  tolerances of ``tests/test_torch_llama.py``.
* The engine's greedy streams equal the JAX ``Engine``'s over a paged pool
  (full and oversubscribed, with preemption and resume) and with prefix
  caching (a hit, a hit after the owner finished, a divergent suffix,
  eviction under pressure), with the same ``free_pages``,
  ``prefix_hit_tokens`` and ``cached_blocks``. The JAX engines run once
  per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.cache_insert import (
    paged_cache_insert_int8 as j_paged_insert)
from quant_tpu.kernels.paged_attention import (
    paged_attention_reference as j_paged_reference)
from quant_tpu.kernels.paged_attention import (
    paged_flash_decode_int8 as j_paged_flash)
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.engine import SamplingConfig
from quant_tpu_torch.kernels.cache_insert import (
    paged_cache_insert_int8_reference)
from quant_tpu_torch.kernels.paged_attention import (
    paged_attention_reference, paged_flash_decode_int8)
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

JCFG = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
TCFG = TConfig(**dataclasses.asdict(JCFG))
L, H, D = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(rng, lengths, page, max_pages):
    """Random int8 pools and a shuffled page table; table entries past each
    slot's pages point at the scratch page 0."""
    b = len(lengths)
    n_pool = 1 + b * max_pages
    pool = (rng.integers(-127, 128, (L, n_pool, H, page, D), dtype=np.int8),
            rng.random((L, n_pool, H, page), np.float32) * 0.02 + 0.01,
            rng.integers(-127, 128, (L, n_pool, H, page, D), dtype=np.int8),
            rng.random((L, n_pool, H, page), np.float32) * 0.02 + 0.01)
    perm = rng.permutation(np.arange(1, n_pool)).reshape(b, max_pages)
    used = -(-np.asarray(lengths) // page)
    tbl = np.where(np.arange(max_pages)[None] < used[:, None], perm, 0)
    return pool, tbl.astype(np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_attention_matches_jax(page):
    rng = np.random.default_rng(page)
    max_pages = 32 // page
    pool, tbl, lens = _pool(rng, [0, 9, 32, 17], page, max_pages)
    q = rng.standard_normal((4, JCFG.n_heads, D), dtype=np.float32)
    jargs = [jnp.asarray(a) for a in (q, *pool, tbl, lens)]
    targs = [torch.from_numpy(a) for a in (q, *pool, tbl, lens)]
    live = lens > 0
    for layer in range(L):
        ref = np.asarray(j_paged_flash(*jargs, layer, interpret=True))
        oracle = np.asarray(j_paged_reference(*jargs, layer))
        got = paged_flash_decode_int8(*targs, layer)
        assert torch.equal(got, paged_attention_reference(*targs, layer))
        assert got.shape == q.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy()[live], oracle[live],
                                   rtol=2e-5, atol=2e-5)
        assert not got.numpy()[~live].any()


@pytest.mark.parametrize("page", [8, 16])
def test_paged_insert_matches_jax(page):
    """Byte-equal, in place; the slot at capacity writes nothing and the
    parked slot writes into the scratch page 0."""
    rng = np.random.default_rng(20 + page)
    max_pages = 32 // page
    lengths = [5, max_pages * page, 0, 19]
    pool, tbl, lens = _pool(rng, lengths, page, max_pages)
    b = len(lengths)
    new = (rng.integers(-127, 128, (b, 1, H, D), dtype=np.int8),
           rng.random((b, 1, H), np.float32),
           rng.integers(-127, 128, (b, 1, H, D), dtype=np.int8),
           rng.random((b, 1, H), np.float32))
    layer = 1
    j = [jnp.asarray(a) for a in (*pool, *new, lens)]
    jtbl = jnp.asarray(tbl)
    scatter = (jllama._paged_insert_at_layer(j[0], j[1], j[4], j[5], j[8],
                                             layer, jtbl)
               + jllama._paged_insert_at_layer(j[2], j[3], j[6], j[7], j[8],
                                               layer, jtbl))
    kernel = j_paged_insert(*j, layer, jtbl, interpret=True)
    tpool = [torch.from_numpy(a.copy()) for a in pool]
    got = paged_cache_insert_int8_reference(
        *tpool, *[torch.from_numpy(a) for a in new], torch.from_numpy(lens),
        layer, torch.from_numpy(tbl))
    for g, t, s, k in zip(got, tpool, scatter, kernel):
        assert g is t                         # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))
        np.testing.assert_array_equal(g.numpy(), np.asarray(k))
    # the parked slot's row landed in the scratch page, the capped one
    # nowhere
    np.testing.assert_array_equal(got[0][layer, 0, :, 0].numpy(),
                                  new[0][2, 0])
    untouched = np.ones(pool[0].shape[1], bool)
    untouched[[0, tbl[0, 0], tbl[3, 19 // page]]] = False
    np.testing.assert_array_equal(got[0][:, untouched].numpy(),
                                  pool[0][:, untouched])


def _gather_slots(pool, tbl):
    """[L, P, H, page(, D)] pool -> slot-contiguous [L, B, H, S(, D)]."""
    g = pool[:, tbl]                        # [L, B, n, H, page(, D)]
    g = np.moveaxis(g, 3, 2)                # [L, B, H, n, page(, D)]
    return g.reshape(*g.shape[:3], -1, *g.shape[5:])


def test_paged_forward_matches_jax():
    """Logits within 1e-4 * max|logit|, or 1e-3 from a slot's first KV
    code that differs by one rounding step (as in test_torch_llama); pool
    codes differ by at most 1 in at most 0.1% of entries, scales within
    1e-5 relative."""
    jparams = jllama.init_params(JCFG, seed=3)
    tparams = params_from_flat(_flatten_params(jax.tree.map(np.asarray,
                                                            jparams)),
                               TCFG, "cpu")
    rng = np.random.default_rng(7)
    b, t, max_seq, page = 2, 12, 32, 8
    n_pool = 1 + b * max_seq // page
    tbl = rng.permutation(np.arange(1, n_pool)).reshape(b, -1).astype(
        np.int32)
    prompt = rng.integers(0, JCFG.vocab_size, (b, t)).astype(np.int32)
    steps = [rng.integers(0, JCFG.vocab_size, (b, 1)).astype(np.int32)
             for _ in range(3)]
    jc = dataclasses.replace(
        jllama.init_paged_cache(JCFG, b, max_seq, n_pool, page),
        page_tbl=jnp.asarray(tbl))
    ref = []
    # one trace for the prefill and one for the decode steps
    fwd = jax.jit(jllama.forward, static_argnames=("cfg",))
    for toks in [prompt] + steps:
        lg, jc = fwd(jparams, jnp.asarray(toks), jc, cfg=JCFG)
        ref.append(np.asarray(lg, np.float32))
    jpool = [np.asarray(a) for a in (jc.k_codes, jc.k_scale, jc.v_codes,
                                     jc.v_scale)]
    for mode in ("xla", "auto"):
        tc = dataclasses.replace(TCFG, kernel_mode=mode)
        cache = tllama.init_paged_cache(tc, b, max_seq, n_pool, page,
                                        device="cpu")
        cache.page_tbl.copy_(torch.from_numpy(tbl))
        got = []
        for toks in [prompt] + steps:
            lg, cache = tllama.forward(tparams, torch.from_numpy(toks), cache,
                                       tc, device="cpu")
            got.append(lg.numpy())
        assert isinstance(cache, tllama.PagedKVCache)
        np.testing.assert_array_equal(cache.lengths.numpy(), [t + 3] * b)
        tpool = [a.numpy() for a in (cache.k_codes, cache.k_scale,
                                     cache.v_codes, cache.v_scale)]
        diff = np.zeros((b, max_seq), bool)
        for jcodes, tcodes in ((jpool[0], tpool[0]), (jpool[2], tpool[2])):
            d = np.abs(jcodes.astype(np.int32) - tcodes.astype(np.int32))
            assert d.max() <= 1
            assert np.mean(d > 0) <= 1e-3, (mode, np.mean(d > 0))
            diff |= (_gather_slots(d, tbl) > 0).any(axis=(0, 2, 4))
        for js, ts in ((jpool[1], tpool[1]), (jpool[3], tpool[3])):
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
        tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref, got):
            assert r.shape == g.shape
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
            assert np.all(err <= tol), (mode, err)
            pos0 += r.shape[1]


# ── engine ─────────────────────────────────────────────────────────────

PAGE = 8
SYS = list(range(100, 100 + 2 * PAGE))   # two full shared blocks


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(x) for x in rng.integers(3, JCFG.vocab_size, n)]
            for n in (20, 13, 5)]


def _prefix_batches():
    """A hit (the second prompt shares the first's two blocks), a hit after
    the owners finished, a divergent second block, then two fresh prompts
    that need pages held only by cached blocks (eviction)."""
    rng = np.random.default_rng(5)
    return [[SYS + [7, 9, 11], SYS + [13, 5]], [SYS + [3]],
            [SYS[:PAGE] + [40] * PAGE + [1]],
            [[int(x) for x in rng.integers(3, 99, 3 * PAGE + 2)]
             for _ in range(2)]]


_PAGED = dict(max_slots=2, max_seq=48, eos_id=-1, paged=True, page_size=PAGE)
_PREFIX = dict(max_slots=2, max_seq=32, eos_id=-1, paged=True, page_size=PAGE,
               prefix_cache=True, n_pages=9)
_STATS = ("free_pages", "total_pages", "prefix_hit_tokens", "cached_blocks")


def _run(eng, make_req, batches, use_block=False, max_new=None):
    """Each batch submitted at once and drained; returns per batch the
    outputs and the pool stats after it."""
    out = []
    for batch in batches:
        reqs = [make_req(req_id=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(batch, max_new or
                                               [4] * len(batch)))]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step_block(3) if use_block else eng.step()
        out.append(([r.output for r in reqs],
                    {k: v for k, v in eng.stats.items() if k in _STATS}))
    return out


def _count_preemptions(eng):
    calls = []
    inner = eng._preempt_newest

    def counted(*a):
        calls.append(1)
        return inner(*a)
    eng._preempt_newest = counted
    return calls


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    flat = _flatten_params(jax.tree.map(np.asarray, jparams))
    return params_from_flat(flat, TCFG, "cpu")


@pytest.fixture(scope="module")
def jax_runs(jparams):
    """The JAX engine's streams and pool stats: the paged pool
    oversubscribed (10 pages where the worst case needs 13), and prefix
    caching over 9 pages."""
    paged = _run(JEngine(jparams, JCFG, n_pages=10, **_PAGED), JRequest,
                 [_prompts()], max_new=[24, 24, 6])
    prefix = _run(JEngine(jparams, JCFG, **_PREFIX), JRequest,
                  _prefix_batches())
    return {"paged": paged, "prefix": prefix}


@pytest.mark.parametrize("use_block,n_pages", [(False, 10), (True, 10),
                                               (False, None)])
def test_paged_engine_matches_jax(jax_runs, tparams, use_block, n_pages):
    """Greedy streams equal the JAX engine's; the 10-page pool preempts and
    resumes (prefilling prompt + output), the full pool never does."""
    eng = TEngine(tparams, TCFG, n_pages=n_pages, device="cpu", **_PAGED)
    preempted = _count_preemptions(eng)
    (outs, stats), = _run(eng, TRequest, [_prompts()], use_block,
                          max_new=[24, 24, 6])
    (j_outs, j_stats), = jax_runs["paged"]
    assert outs == j_outs
    assert [len(o) for o in outs] == [24, 24, 6]
    assert stats["free_pages"] == stats["total_pages"]
    if n_pages is None:
        assert not preempted
    else:
        assert preempted
        assert stats == j_stats


@pytest.mark.parametrize("use_block", [False, True])
def test_prefix_cache_matches_jax(jax_runs, tparams, use_block):
    eng = TEngine(tparams, TCFG, device="cpu", **_PREFIX)
    got = _run(eng, TRequest, _prefix_batches(), use_block)
    ref = jax_runs["prefix"]
    assert [o for o, _ in got] == [o for o, _ in ref]
    assert [s for _, s in got] == [s for _, s in ref]
    hits = [s["prefix_hit_tokens"] for _, s in got]
    # both SYS blocks (second request), both again after the owners
    # finished, then only the first block of the divergent prompt
    assert hits[:3] == [2 * PAGE, 4 * PAGE, 5 * PAGE]
    # the fresh prompts need 8 pages; only 5 were free, so cached blocks
    # were evicted
    assert got[2][1]["free_pages"] < 8
    assert got[3][1]["free_pages"] + got[3][1]["cached_blocks"] == 8


def test_preempted_sampled_stream_continues(tparams):
    """A sampled request that is preempted and resumed carries its slot
    generator's state: its stream equals the one from a pool that never
    preempts."""
    prompts = _prompts()
    outs = []
    for n_pages in (None, 10):
        eng = TEngine(tparams, TCFG, n_pages=n_pages, device="cpu", **_PAGED)
        preempted = _count_preemptions(eng)
        reqs = [TRequest(req_id=i, prompt=p, max_new_tokens=24, seed=11 + i,
                         sampling=SamplingConfig(temperature=0.9, top_k=40))
                for i, p in enumerate(prompts[:2])]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        assert bool(preempted) == (n_pages is not None)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_admission_in_progress_never_writes_shared_pages(tparams):
    """While a prefix-cached admission is still prefilling (several
    chunks), the other slot keeps decoding. The admitting slot's device
    table row stays parked on the scratch page until its admission
    completes, so the decode step's write for it cannot land in the shared
    prefix pages: both streams equal those of a contiguous engine."""
    rng = np.random.default_rng(9)
    a = SYS + [7, 9, 11]
    b = SYS + [int(x) for x in rng.integers(3, 99, 20)]
    eng = TEngine(tparams, TCFG, max_slots=2, max_seq=64, eos_id=-1,
                  paged=True, page_size=PAGE, prefix_cache=True,
                  device="cpu")
    eng.PREFILL_CHUNK = PAGE      # b's 20-token suffix takes three chunks
    ra = TRequest(req_id=0, prompt=a, max_new_tokens=12)
    rb = TRequest(req_id=1, prompt=b, max_new_tokens=6)
    eng.add_request(ra)
    while eng._prefilling is not None or eng.pending:
        eng.step()
    eng.add_request(rb)
    steps_while_b_prefills = 0
    while eng.has_work():
        if eng._prefilling is not None or eng.pending:
            steps_while_b_prefills += 1
        eng.step()
    assert steps_while_b_prefills >= 3
    assert eng.stats["prefix_hit_tokens"] == 2 * PAGE
    ref = TEngine(tparams, TCFG, max_slots=1, max_seq=64, eos_id=-1,
                  device="cpu")
    assert [ra.output, rb.output] == [ref.generate([a], 12)[0],
                                      ref.generate([b], 6)[0]]
