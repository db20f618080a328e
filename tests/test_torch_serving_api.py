"""The port's serving API against the JAX package (CPU, test-tiny float32).

Both packages get the same parameters (the JAX ``init_params`` weights
carried across by ``params_from_flat``) and the same numpy-seeded inputs.

* Grammar: the port's ``regex_fsm``, ``json_fsm``, ``choice_fsm``,
  ``token_fsm`` and ``json_schema_regex`` give byte-equal tables and regex
  strings on the patterns and schemas of ``tests/test_grammar.py``
  (multibyte tokens and a dead row among them).
* Sampler: ``apply_penalties``, ``apply_logit_bias``, greedy ``sample`` /
  ``sample_batch`` with penalties, bias and FSM rows within 1e-6 relative
  (the ±inf masks equal, the ids exact); the FSM mask rows and byte walk
  exact; the top-N logprobs' ids exact and values within 1e-6.
* Engine: one batch mixing penalized greedy requests, a ``logit_bias`` ban
  and force, a regex FSM, a choice FSM, ``top_logprobs`` = 3 and stop ids
  gives the JAX engine's streams token for token, contiguous and paged
  with the prefix cache, through ``step`` and ``step_block``. Logprobs and
  top logprobs lie within 1e-4 of max|logit| of the JAX engine's, and
  within 1e-3 from a slot's first KV code that differs from JAX's (a
  rounding tie: ROADMAP.md queue 3). One module-scoped JAX run serves every
  engine test. A paged engine that preempts a penalized FSM request gives
  the stream of one large enough not to. ``Engine.embed`` is within 1e-5 of
  JAX's, and ``forward(return_hidden=True)`` of a dense, a MoE and an MLA
  model gives the hidden states whose ``lm_head`` product is the logits.
* Server: the cases of ``tests/test_server.py`` that need neither LoRA nor
  speculation, against the port's server with the same stub tokenizer; the
  greedy answers equal the JAX server's.
* ``generate --prompt --tokenizer`` with a byte-level BPE tokenizer prints
  the JAX CLI's JSON lines; ``loadgen`` draws JAX's arrivals and reports
  JAX's keys.
"""

import dataclasses
import json
import re
import threading
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
from quant_tpu.engine import SamplingConfig as JSampling
from quant_tpu.engine import engine as jengine
from quant_tpu.engine import grammar as jgrammar
from quant_tpu.engine import sampler as jsampler
from quant_tpu.engine.server import serve_async as jserve_async
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.engine import SamplingConfig as TSampling
from quant_tpu_torch.engine import engine as tengine
from quant_tpu_torch.engine import grammar as tgrammar
from quant_tpu_torch.engine import sampler as tsampler
from quant_tpu_torch.engine.server import serve_async as tserve_async
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

JCFG = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
TCFG = TConfig(**dataclasses.asdict(JCFG))
V = JCFG.vocab_size
EOS = 500
# the server is local: never route through a proxy from the environment
_OPEN = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(jparams):
    return _flatten_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_flat(_flat(jparams), TCFG, "cpu")


# ── grammar ──────────────────────────────────────────────────────────────


def _digit_vocab(v: int, eos: int) -> list[bytes]:
    """ids 0..9 spell digits, the others letters; EOS spells nothing."""
    vocab = [b"%d" % i if i < 10 else bytes([97 + i % 26]) for i in range(v)]
    vocab[eos] = b""
    return vocab


def _text_vocab(v: int, eos: int) -> list[bytes]:
    """One printable byte per id 32..126, a few multibyte tokens above,
    nothing elsewhere (JSON text is spellable)."""
    vocab = [bytes([i]) if 32 <= i < 127 else b"" for i in range(v)]
    for i, t in enumerate([b"ab", b"abab", b"12", b'{"', b'":', b"true",
                           b", ", b"  "]):
        vocab[200 + i] = t
    vocab[eos] = b""
    return vocab


_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 3},
    "ok": {"type": "boolean"}}}
_RECURSIVE = {"type": "object", "properties": {
    "v": {"type": "integer"},
    "kids": {"type": "array", "minItems": 0, "maxItems": 2,
             "items": {"$ref": "#"}}}}
_NESTED = {"type": "object", "properties": {
    "rows": {"type": "array", "minItems": 1, "maxItems": 2,
             "items": {"type": "object", "properties": {
                 "id": {"type": "integer"}, "ok": {"type": "boolean"}}}}}}
_PATTERNS = [r"-?\d+(\.\d+)?", r"(yes|no|maybe)", r"[a-f0-9]{4}", r"a+b*c?",
             r"[^0-9]{2}", r"\w+@\w+\.(com|org)", r"a{2,3}", r"\d{3}"]


def _fsm_case(kind, arg, pkg):
    """(TokenFSM, regex string or None) of one grammar case in ``pkg``."""
    if kind == "regex":
        return pkg.regex_fsm(arg, _digit_vocab(V, EOS), EOS), None
    if kind == "text-regex":
        return pkg.regex_fsm(arg, _text_vocab(V, EOS), EOS), None
    if kind == "dead-row":
        vocab = [b""] * V
        vocab[12] = b"a"        # only "a" is spellable: "q" never is
        return pkg.regex_fsm("aq", vocab, 7), None
    if kind == "multibyte":
        tb, acc = pkg.compile_regex(r"(ab)+")
        return pkg.token_fsm(tb, acc, [b"ab", b"a", b"b", b"abab", b"c", b""],
                             5), None
    if kind == "schema":
        schema, depth = arg
        rx = pkg.json_schema_regex(schema, max_depth=depth)
        tb, acc = pkg.compile_regex(rx, max_states=65536)
        return pkg.token_fsm(tb, acc, _text_vocab(V, EOS), EOS), rx
    if kind == "json":
        return pkg.json_fsm(arg, _text_vocab(V, EOS), EOS,
                            max_states=16384), None
    return pkg.choice_fsm(arg, V, EOS), None


@pytest.mark.parametrize("kind,arg", [
    *[("regex", p) for p in _PATTERNS],
    ("text-regex", r"[a-z ]{2,6}(ab)?"),
    ("dead-row", None), ("multibyte", None),
    ("schema", (_SCHEMA, 4)),
    ("schema", ({"type": "array", "items": {"type": "integer"},
                 "minItems": 2, "maxItems": 3}, 4)),
    ("schema", (_RECURSIVE, 2)),
    ("schema", ({"$defs": {"leafy": {"type": "boolean"}}, "type": "array",
                 "items": {"$ref": "#/$defs/leafy"}, "maxItems": 2}, 4)),
    ("json", _NESTED),
    ("choice", [[10, 11, 12], [20, 21], [10, 13]]),
])
def test_grammar_tables_equal_jax(kind, arg):
    got, got_rx = _fsm_case(kind, arg, tgrammar)
    ref, ref_rx = _fsm_case(kind, arg, jgrammar)
    assert got_rx == ref_rx
    for f in ("bits", "byte_trans", "tok_bytes", "tok_len"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.eos_id, got.start) == (ref.eos_id, ref.start)


# ── sampler ──────────────────────────────────────────────────────────────


def _pen_inputs(seed=0, b=4):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((b, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 3, (b, V)).astype(np.int32)
    counts[rng.random((b, V)) < 0.6] = 0
    reps = np.asarray([1.0, 1.3, 0.8, 2.0][:b], np.float32)
    freqs = np.asarray([0.0, 0.2, 0.5, 1.0][:b], np.float32)
    press = np.asarray([0.0, 0.5, 0.0, 1.5][:b], np.float32)
    toks = rng.integers(0, V, (b, 6)).astype(np.int32)
    toks[:, 5] = toks[:, 4]            # a repeated id adds twice
    vals = (rng.standard_normal((b, 6)) * 50).astype(np.float32)
    vals[0, :3] = [-100.0, 100.0, -100.0]
    return lg, counts, (reps, freqs, press), (toks, vals)


def _rel(a, b):
    """Max relative error of two arrays over their finite entries; the ±inf
    entries must sit at the same places."""
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    f = np.isfinite(b)
    return float(np.max(np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1.0)))


def test_penalties_and_bias_match_jax():
    lg, counts, knobs, (toks, vals) = _pen_inputs()
    t = torch.from_numpy
    got = tsampler.apply_penalties(t(lg), t(counts), *map(t, knobs)).numpy()
    ref = np.asarray(jax.jit(jsampler.apply_penalties)(
        jnp.asarray(lg), jnp.asarray(counts), *map(jnp.asarray, knobs)))
    assert _rel(got, ref) <= 1e-6
    got = tsampler.apply_logit_bias(t(lg), t(toks), t(vals)).numpy()
    ref = np.asarray(jax.jit(jsampler.apply_logit_bias)(
        jnp.asarray(lg), jnp.asarray(toks), jnp.asarray(vals)))
    assert _rel(got, ref) <= 1e-6


def test_greedy_sampling_with_penalties_bias_and_fsm_matches_jax():
    lg, counts, knobs, (toks, vals) = _pen_inputs(1)
    b = lg.shape[0]
    rng = np.random.default_rng(2)
    rows = np.where(rng.random((b, V)) < 0.7, -1, 0).astype(np.int32)
    rows[:, 3] = 0                     # every row keeps a legal token
    t = torch.from_numpy
    zeros = np.zeros((b,), np.float32)
    got = tsampler.sample_batch(
        t(lg), t(zeros), t(zeros.astype(np.int64)), t(zeros + 1), t(zeros),
        [None] * b, penalties=(t(counts), *map(t, knobs)),
        bias=(t(toks), t(vals)), fsm_rows=t(rows)).numpy()
    ref = np.asarray(jax.jit(jsampler.sample_batch)(
        jnp.asarray(lg), jax.random.key(0), jnp.zeros((b,)),
        jnp.zeros((b,), jnp.int32), jnp.ones((b,)), jnp.zeros((b,)),
        (jnp.asarray(counts), *map(jnp.asarray, knobs)),
        (jnp.asarray(toks), jnp.asarray(vals)), fsm_rows=jnp.asarray(rows)))
    np.testing.assert_array_equal(got, ref)
    assert np.all(rows[np.arange(b), got] == 0)
    # one config on one row (the first token of an admission)
    cfg = dict(repetition_penalty=1.3, presence_penalty=0.7,
               frequency_penalty=0.1, logit_bias=((int(ref[0]), -100.0),))
    got1 = tsampler.sample(t(lg[:1]), TSampling(**cfg), counts=t(counts[:1]),
                           fsm_rows=t(rows[:1])).numpy()
    ref1 = np.asarray(jax.jit(jsampler.sample, static_argnums=2)(
        jnp.asarray(lg[:1]), jax.random.key(0), JSampling(**cfg),
        counts=jnp.asarray(counts[:1]), fsm_rows=jnp.asarray(rows[:1])))
    np.testing.assert_array_equal(got1, ref1)
    assert got1[0] != ref[0]


def test_top_logprobs_match_jax():
    lg = _pen_inputs(3)[0]
    ids, lps = tsampler.top_logprobs(torch.from_numpy(lg), 5)
    rids, rlps = jax.jit(jengine._top_logprobs, static_argnums=1)(
        jnp.asarray(lg), 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(lps.numpy(), np.asarray(rlps), rtol=1e-6,
                               atol=1e-6)


def test_fsm_mask_rows_and_walk_match_jax(jax_run, tparams):
    """The port's registry holds the JAX engine's stacks after the same
    registrations (the mixed batch's two FSMs, then a third); the mask rows
    and the byte walk over them are exact."""
    je = jax_run["engine"]
    te = TEngine(tparams, TCFG, max_slots=1, max_seq=16, eos_id=EOS,
                 device="cpu")
    for r in _requests(TRequest, TSampling, tgrammar):
        if r.fsm is not None:
            te.register_fsm(r.fsm)
    third = r"[a-z ]{2,6}(ab)?"
    assert je.register_fsm(jgrammar.regex_fsm(
        third, _text_vocab(V, EOS), EOS)) == te.register_fsm(
        tgrammar.regex_fsm(third, _text_vocab(V, EOS), EOS)) == 3
    stacks = [(je._fsm_bits, te._fsm_bits), (je._fsm_bt, te._fsm_bt),
              (je._fsm_tokb, te._fsm_tokb), (je._fsm_tokl, te._fsm_tokl)]
    for a, b in stacks:
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    rng = np.random.default_rng(4)
    n = 64
    ids = rng.integers(0, 4, n)
    states = np.asarray([rng.integers(0, je._fsm_objs[i].n_states) if i
                         else 0 for i in ids])
    toks = rng.integers(0, V, n)
    toks[::7] = EOS
    ref = np.asarray(jax.jit(jengine._fsm_mask_rows, static_argnums=3)(
        je._fsm_bits, jnp.asarray(ids), jnp.asarray(states), V))
    got = tengine._fsm_mask_rows(te._fsm_bits, torch.from_numpy(ids),
                                 torch.from_numpy(states), V).numpy()
    np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jax.jit(jengine._fsm_walk, static_argnums=6)(
        je._fsm_bt, je._fsm_tokb, je._fsm_tokl, jnp.asarray(ids),
        jnp.asarray(states, jnp.int32), jnp.asarray(toks, jnp.int32), EOS))
    got = tengine._fsm_walk(te._fsm_bt, te._fsm_tokb, te._fsm_tokl,
                            torch.from_numpy(ids), torch.from_numpy(states),
                            torch.from_numpy(toks), EOS).numpy()
    np.testing.assert_array_equal(got, ref)


# ── engine ───────────────────────────────────────────────────────────────

PREFIX = [int(t) for t in np.random.default_rng(5).integers(0, V, 16)]
STOP_IDS = tuple(range(0, V, 3))
N_NEW = 8
# two lengths under one JAX prefill bucket (16)
EMBED_INPUTS = ([5, 6, 7], PREFIX[:12] + [9])


def _requests(pkg_request, pkg_sampling, grammar):
    """The mixed batch, built alike in both packages: a shared 16-token
    prefix (two pages of 8) and a numpy-seeded suffix each."""
    rng = np.random.default_rng(6)
    regex = grammar.regex_fsm(r"\d{2,4}", _digit_vocab(V, EOS), EOS)
    choice = grammar.choice_fsm([[10, 11, 12], [20, 21]], V, EOS)
    pen = dict(repetition_penalty=1.3, presence_penalty=0.5,
               frequency_penalty=0.2)
    kinds = [
        dict(sampling=pkg_sampling(**pen), top_logprobs=3),
        dict(sampling=pkg_sampling(logit_bias=tuple(
            (t, -100.0) for t in range(0, V, 2)))),
        dict(sampling=pkg_sampling(logit_bias=((77, 100.0),)),
             top_logprobs=3),
        dict(sampling=pkg_sampling(repetition_penalty=1.2), fsm=regex,
             top_logprobs=3),
        dict(fsm=choice),
        dict(sampling=pkg_sampling(frequency_penalty=0.3), stop_ids=STOP_IDS),
        dict(top_logprobs=3),
    ]
    return [pkg_request(req_id=i, prompt=PREFIX + [int(t) for t in
                                                   rng.integers(0, V, 3 + i)],
                        max_new_tokens=N_NEW, **kw)
            for i, kw in enumerate(kinds)]


def _drive(eng, reqs, use_block):
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step_block(4) if use_block else eng.step()
    return reqs


def _codes(cache):
    return [np.asarray(x) for x in (cache.k_codes, cache.v_codes)]


@pytest.fixture(scope="module")
def jax_run(jparams):
    """The JAX engine's run of the mixed batch (contiguous, one request a
    slot, one step_block of every decode forward: one program to compile),
    its embeddings of two inputs, and the keys of a loadgen report (a run
    of no requests over that engine: its stats hold the latency
    percentiles)."""
    from quant_tpu.engine import loadgen as jloadgen

    eng = JEngine(jparams, JCFG, max_slots=7, max_seq=64, eos_id=EOS)
    reqs = _requests(JRequest, JSampling, jgrammar)
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step_block(N_NEW)
    emb = [eng.embed(ids) for ids in EMBED_INPUTS]
    load = jloadgen.run_load(eng, jloadgen.LoadSpec(n_requests=0,
                                                    warmup=False))
    return {"reqs": reqs, "codes": _codes(eng.cache), "embed": emb,
            "load_keys": sorted(load), "engine": eng}


@pytest.fixture(scope="module")
def taint(jax_run, tparams):
    """Per request, per output position: whether the forward that produced
    it read a KV code that differs from JAX's (the port's contiguous cache
    against the JAX engine's, slot by slot), and the position's max|logit|
    (teacher forcing through the port's plain forward)."""
    eng = TEngine(tparams, TCFG, max_slots=7, max_seq=64, eos_id=EOS,
                  device="cpu")
    reqs = _drive(eng, _requests(TRequest, TSampling, tgrammar), True)
    diff = np.zeros((7, 64), bool)
    for a, b in zip(jax_run["codes"], _codes(eng.cache)):
        diff |= (a != b).any(axis=(0, 2, 4))
    first = [int(np.argmax(d)) if d.any() else 64 for d in diff]
    tainted, scale = [], []
    for i, r in enumerate(jax_run["reqs"]):
        n = len(r.prompt)
        # output j came from the forward over positions <= n - 1 + j
        tainted.append([n - 1 + j >= first[i] for j in range(len(r.output))])
        toks = torch.tensor([r.prompt + r.output[:-1]])
        lg, _ = tllama.forward(tparams, toks,
                               tllama.init_cache(TCFG, 1, 64, "cpu"), TCFG,
                               device="cpu")
        scale.append(lg[0, n - 1:].abs().amax(-1).numpy())
    return tainted, scale


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("use_block", [False, True], ids=["step", "block"])
def test_engine_streams_match_jax(jax_run, taint, tparams, paged, use_block):
    kw = (dict(paged=True, page_size=8, prefix_cache=True) if paged else {})
    eng = TEngine(tparams, TCFG, max_slots=7, max_seq=64, eos_id=EOS,
                  device="cpu", **kw)
    got = _drive(eng, _requests(TRequest, TSampling, tgrammar), use_block)
    tainted, scale = taint
    for g, r, tn, sc in zip(got, jax_run["reqs"], tainted, scale):
        assert g.output == r.output, g.req_id
        tol = np.where(tn, 1e-3, 1e-4) * sc[:len(r.output)]
        assert np.all(np.abs(np.subtract(g.logprobs, r.logprobs)) <= tol)
        assert len(g.top_ids) == (len(g.output) if g.top_logprobs else 0)
        for j, (gi, ri, gl, rl) in enumerate(zip(g.top_ids, r.top_ids,
                                                 g.top_lps, r.top_lps)):
            assert gi == ri, (g.req_id, j)
            assert np.all(np.abs(np.subtract(gl, rl)) <= tol[j])
    # what each request asked for shows in its stream
    out = [g.output for g in got]
    assert all(t % 2 for t in out[1]) and out[2] == [77] * N_NEW
    assert out[3][-1] == EOS and re.fullmatch(
        r"\d{2,4}", "".join(str(t) for t in out[3][:-1]))
    assert out[4] in ([10, 11, 12, EOS], [20, 21, EOS])
    assert out[5][-1] in STOP_IDS and len(out[5]) < N_NEW
    assert [t[0] for t in got[6].top_ids] == out[6]
    if paged:
        assert eng.stats["prefix_hit_tokens"] == 6 * len(PREFIX)


def test_preempted_penalized_fsm_request_resumes(tparams):
    """Two slots over a pool too small for both: the newest request (a
    penalized FSM one) is preempted, resumes with its counts and FSM state
    rebuilt, and gives the stream of an engine large enough not to."""
    def run(n_pages):
        eng = TEngine(tparams, TCFG, max_slots=2, max_seq=64, eos_id=EOS,
                      device="cpu", paged=True, page_size=8, n_pages=n_pages)
        preempted = []
        inner = eng._preempt_newest

        def spy():
            preempted.append([r and r.req_id for r in eng.slots])
            return inner()
        eng._preempt_newest = spy
        fsm = tgrammar.regex_fsm(r"[a-z]{20,24}", _text_vocab(V, EOS), EOS)
        reqs = [TRequest(req_id=0, prompt=PREFIX, max_new_tokens=30),
                TRequest(req_id=1, prompt=PREFIX[:9], max_new_tokens=30,
                         fsm=fsm, sampling=TSampling(
                             repetition_penalty=1.5, presence_penalty=0.8))]
        _drive(eng, reqs, False)
        return [r.output for r in reqs], preempted
    small, preempted = run(1 + 7)
    big, none = run(None)
    assert preempted and not none
    assert small == big
    vocab = _text_vocab(V, EOS)
    assert small[1][-1] == EOS and re.fullmatch(
        b"[a-z]{20,24}", b"".join(vocab[t] for t in small[1][:-1]))
    assert len(set(small[1][:-1])) > 5       # the penalties spread it


def test_embed_matches_jax(jax_run, tparams):
    eng = TEngine(tparams, TCFG, max_slots=2, max_seq=64, eos_id=EOS,
                  device="cpu")
    for ids, ref in zip(EMBED_INPUTS, jax_run["embed"]):
        got = eng.embed(ids)
        assert got.shape == (TCFG.dim,)
        assert np.max(np.abs(got - ref)) <= 1e-5
    with pytest.raises(ValueError):
        eng.embed([])


@pytest.mark.parametrize("preset", ["test-tiny", "test-tiny-moe",
                                    "test-tiny-mla"])
def test_return_hidden_gives_the_logits_hidden_states(preset):
    """forward(return_hidden=True) returns the f32 final-norm hidden states
    of every family, and updates the cache: their lm_head product is the
    logits of the plain forward."""
    cfg = dataclasses.replace(TConfig(**dataclasses.asdict(JPRESETS[preset])),
                              dtype="float32")
    params = tllama.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 5)))
    h, c1 = tllama.forward(params, toks, tllama.init_cache(cfg, 2, 16, "cpu"),
                           cfg, return_hidden=True, device="cpu")
    lg, c2 = tllama.forward(params, toks, tllama.init_cache(cfg, 2, 16, "cpu"),
                            cfg, device="cpu")
    assert h.shape == (2, 5, cfg.dim) and h.dtype == torch.float32
    assert torch.equal(c1.lengths, c2.lengths)
    assert torch.equal(c1.k_codes, c2.k_codes)
    got = tllama._mm(cfg)(h, params.lm_head, out_dtype=torch.float32)
    assert torch.allclose(got[..., :cfg.vocab_size], lg, rtol=0, atol=1e-5)


# ── server ───────────────────────────────────────────────────────────────


class _StubTokenizer:
    """The JAX server tests' duck-typed tokenizer: 1 char = 1 token."""

    def encode(self, text):
        return [ord(c) % 50 + 3 for c in text]

    def decode(self, ids):
        return "".join(chr((t - 3) % 50 + 97) for t in ids)

    def apply_chat_template(self, messages, add_generation_prompt=False):
        ids = []
        for m in messages:
            ids += self.encode(m["role"]) + self.encode(m["content"])
        return ids + ([1] if add_generation_prompt else [])


def _post(base, path, payload, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with _OPEN(req, timeout=timeout) as r:
        return json.loads(r.read())


def _sse(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with _OPEN(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            raw = raw.strip()
            if raw.startswith(b"data: "):
                if raw[6:] == b"[DONE]":
                    return events
                events.append(json.loads(raw[6:]))
    raise AssertionError("no [DONE]")


def _status(base, path, payload):
    try:
        _post(base, path, payload, timeout=30)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def _server(serve, eng, tokenizer):
    httpd, srv = serve(eng, tokenizer=tokenizer, model_name="tiny-test")
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, srv


def _stop(servers):
    """Shut the servers down together (each waits out a 0.5 s poll)."""
    def one(httpd, srv):
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    threads = [threading.Thread(target=one, args=u[1:]) for u in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)


@pytest.fixture(scope="module")
def servers(jparams, tparams):
    """(port base, JAX base, port base without a tokenizer): engines of 4
    slots, max_seq 64, no EOS, over the same parameters."""
    kw = dict(max_slots=4, max_seq=64, eos_id=-1)
    up = [_server(tserve_async, TEngine(tparams, TCFG, device="cpu", **kw),
                  _StubTokenizer()),
          _server(jserve_async, JEngine(jparams, JCFG, **kw),
                  _StubTokenizer()),
          _server(tserve_async, TEngine(tparams, TCFG, device="cpu", **kw),
                  None)]
    yield [u[0] for u in up]
    _stop(up)


def _close(a, b, tol=2e-3):
    """Logprobs of the two servers: a KV code at a rounding tie moves them
    by up to 1e-3 of max|logit| (ROADMAP.md queue 3); test-tiny's logits
    stay under 2 in magnitude."""
    return np.max(np.abs(np.subtract(a, b))) <= tol


def test_openai_endpoints_match_jax_server(servers):
    """Token and text prompts, SSE, chat and top-logprobs on
    /v1/completions and /generate: the greedy answers equal the JAX
    server's."""
    tb, jb, _ = servers
    prompt = [5, 9, 11]
    models = json.loads(_OPEN(tb + "/v1/models", timeout=30).read())
    assert models["data"][0]["id"] == "tiny-test"
    native = _post(tb, "/generate", {"prompt_ids": prompt,
                                     "max_new_tokens": 6})["output_ids"]
    assert native == _post(jb, "/generate", {"prompt_ids": prompt,
                                             "max_new_tokens": 6})[
        "output_ids"]
    for payload in ({"prompt": prompt, "max_tokens": 6, "temperature": 0,
                     "logprobs": True},
                    {"prompt": "hi", "max_tokens": 4, "temperature": 0},
                    {"prompt": prompt, "max_tokens": 4, "temperature": 0,
                     "logprobs": 2}):
        got = _post(tb, "/v1/completions", payload)
        ref = _post(jb, "/v1/completions", payload)
        g, r = got["choices"][0], ref["choices"][0]
        assert (g["token_ids"], g["text"], g["finish_reason"]) == (
            r["token_ids"], r["text"], r["finish_reason"])
        assert got["usage"] == ref["usage"]
        assert got["object"] == ref["object"] == "text_completion"
        if "logprobs" in payload:
            assert _close(g["logprobs"]["token_logprobs"],
                          r["logprobs"]["token_logprobs"])
        if payload.get("logprobs") == 2:
            assert g["logprobs"]["top_token_ids"] == r["logprobs"][
                "top_token_ids"]
            assert [list(d) for d in g["logprobs"]["top_logprobs"]] == [
                list(d) for d in r["logprobs"]["top_logprobs"]]
            assert [t[0] for t in g["logprobs"]["top_token_ids"]] == g[
                "token_ids"]
    assert _post(tb, "/v1/completions", {
        "prompt": prompt, "max_tokens": 6, "temperature": 0})["choices"][0][
        "token_ids"] == native
    # SSE deltas concatenate to the blocking answer
    events = _sse(tb, "/v1/completions", {"prompt": prompt, "max_tokens": 6,
                                          "temperature": 0})
    chunks = [e["choices"][0] for e in events]
    assert sum((c["token_ids"] for c in chunks), []) == native
    assert "".join(c["text"] for c in chunks) == _StubTokenizer().decode(
        native)
    assert [c["finish_reason"] for c in chunks if c["finish_reason"]] == [
        "length"]
    # chat through the stub template
    msgs = [{"role": "user", "content": "ab"}]
    payload = {"messages": msgs, "max_tokens": 5, "temperature": 0}
    got = _post(tb, "/v1/chat/completions", payload)
    ref = _post(jb, "/v1/chat/completions", payload)
    assert got["object"] == "chat.completion"
    assert got["choices"][0]["message"] == ref["choices"][0]["message"]
    assert got["choices"][0]["token_ids"] == ref["choices"][0]["token_ids"]
    assert got["usage"] == ref["usage"]
    events = _sse(tb, "/v1/chat/completions", payload)
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert sum((e["choices"][0]["token_ids"] for e in events), []) == got[
        "choices"][0]["token_ids"]
    # /generate top logprobs, blocking and streamed (in the done line)
    payload = {"prompt_ids": [5, 6], "max_new_tokens": 3, "top_logprobs": 2}
    got = _post(tb, "/generate", payload)
    ref = _post(jb, "/generate", payload)
    assert got["top_token_ids"] == ref["top_token_ids"]
    assert _close(got["top_logprobs"], ref["top_logprobs"])
    req = urllib.request.Request(
        tb + "/generate",
        data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with _OPEN(req, timeout=120) as r:
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln]
    assert lines[-1]["done"]
    assert lines[-1]["top_token_ids"] == ref["top_token_ids"]
    # bad prompts answer 400
    for bad in ({"prompt": []}, {"prompt": 7}, {}):
        assert _status(tb, "/v1/completions", bad)[0] == 400


def test_logit_bias_and_tokenizerless_server(servers):
    """Without a tokenizer: token prompts answer with empty text, a
    logit_bias ban holds (equal to the JAX server's answer), an id outside
    the vocab, a text prompt, chat and stop strings answer 400."""
    tb, jb, nb = servers
    out = _post(nb, "/v1/completions", {"prompt": [4, 5], "max_tokens": 3,
                                        "temperature": 0})["choices"][0]
    assert out["text"] == "" and len(out["token_ids"]) == 3
    banned = out["token_ids"][0]
    payload = {"prompt": [4, 5], "max_tokens": 3, "temperature": 0,
               "logit_bias": {str(banned): -1e9}}
    got = _post(nb, "/v1/completions", payload)["choices"][0]["token_ids"]
    assert banned not in got
    assert got == _post(jb, "/v1/completions", payload)["choices"][0][
        "token_ids"]
    for path, payload in (
            ("/v1/completions", {"prompt": "hello"}),
            ("/v1/chat/completions", {"messages": []}),
            ("/v1/completions", {"prompt": [5], "max_tokens": 2,
                                 "stop": "x"}),
            ("/generate", {"prompt_ids": [5], "guided_regex": "a"})):
        code, err = _status(nb, path, payload)
        assert code == 400 and "tokenizer" in err["error"]
    code, err = _status(nb, "/generate", {"prompt_ids": [5],
                                          "logit_bias": {str(V): 1.0}})
    assert code == 400 and "logit_bias" in err["error"]
    for bad in ([-1], [V], []):
        assert _status(nb, "/generate", {"prompt_ids": bad,
                                         "repetition_penalty": 1.2})[0] == 400
    assert len(_post(nb, "/generate", {"prompt_ids": [5, 6],
                                       "max_new_tokens": 3})[
        "output_ids"]) == 3


def test_n_choices_and_seed(servers):
    tb = servers[0]
    out = _post(tb, "/v1/completions", {"prompt": [6, 7], "max_tokens": 4,
                                        "n": 3, "temperature": 0})
    ids = [c["token_ids"] for c in out["choices"]]
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert ids[0] == ids[1] == ids[2] and len(ids[0]) == 4
    assert out["usage"]["completion_tokens"] == 12
    assert _status(tb, "/v1/completions", {"prompt": [6, 7], "n": 2,
                                           "stream": True})[0] == 400
    body = {"prompt": [5, 9, 11], "max_tokens": 6, "temperature": 1.0,
            "seed": 42}
    outs = [_post(tb, "/v1/completions", body)["choices"][0]["token_ids"]
            for _ in range(2)]
    assert outs[0] == outs[1]
    other = _post(tb, "/v1/completions", dict(body, seed=43))
    assert other["choices"][0]["token_ids"] != outs[0]
    chs = _post(tb, "/v1/completions", dict(body, n=2))["choices"]
    assert chs[0]["token_ids"] == outs[0]
    assert chs[1]["token_ids"] != chs[0]["token_ids"]


def test_guided_decoding_endpoints(tparams):
    """guided_choice (token ids), guided_regex over the stub tokenizer's
    vocab, guided_json over a byte tokenizer, sampled; exclusive fields
    answer 400."""
    class _JsonStub:
        # id i in [3, 130) decodes to chr(i): enough for JSON text
        def encode(self, text):
            return [ord(c) for c in text]

        def decode(self, ids):
            return "".join(chr(t) if 3 <= t < 130 else "" for t in ids)

    up = [_server(tserve_async, TEngine(tparams, TCFG, max_slots=4,
                                        max_seq=64, eos_id=7, device="cpu"),
                  _StubTokenizer()),
          _server(tserve_async, TEngine(tparams, TCFG, max_slots=2,
                                        max_seq=64, eos_id=2, device="cpu"),
                  _JsonStub())]
    (base, _, srv), (jbase, _, _) = up
    try:
        out = _post(base, "/generate", {
            "prompt_ids": [5, 9], "max_new_tokens": 8, "temperature": 1.0,
            "guided_choice": [[30, 31, 32], [40, 41]]})["output_ids"]
        assert out in ([30, 31, 32, 7], [40, 41, 7]), out
        a_ids = {t for t in range(V) if _StubTokenizer().decode([t]) == "a"}
        ch = _post(base, "/v1/completions", {
            "prompt": [5, 9], "max_tokens": 8, "temperature": 1.0,
            "guided_regex": "a{3}"})["choices"][0]
        assert len(ch["token_ids"]) == 4 and ch["token_ids"][-1] == 7
        assert all(t in a_ids for t in ch["token_ids"][:3])
        assert srv.guided_fsm({"guided_regex": "a{3}"}) is srv.guided_fsm(
            {"guided_regex": "a{3}"})
        assert _status(base, "/generate", {
            "prompt_ids": [5], "guided_regex": "a",
            "guided_choice": [[1]]})[0] == 400
        ch = _post(jbase, "/v1/completions", {
            "prompt": [5, 9], "max_tokens": 24, "temperature": 1.0,
            "guided_json": {"type": "array", "items": {"type": "boolean"},
                            "minItems": 1, "maxItems": 2}})["choices"][0]
        parsed = json.loads(ch["text"])
        assert isinstance(parsed, list) and 1 <= len(parsed) <= 2
        assert all(isinstance(x, bool) for x in parsed)
    finally:
        _stop(up)


def test_embeddings_endpoint_matches_jax_server(servers):
    tb, jb, _ = servers
    payload = {"input": [[5, 6, 7], "hello"]}
    got, ref = _post(tb, "/v1/embeddings", payload), _post(
        jb, "/v1/embeddings", payload)
    assert len(got["data"]) == 2 and got["usage"] == ref["usage"]
    for g, r in zip(got["data"], ref["data"]):
        assert g["index"] == r["index"]
        assert _close(g["embedding"], r["embedding"], 1e-5)
    v0 = np.asarray(got["data"][0]["embedding"])
    assert abs(np.linalg.norm(v0) - 1.0) < 1e-5
    again = _post(tb, "/v1/embeddings", {"input": [5, 6, 7]})
    assert _close(again["data"][0]["embedding"], v0, 1e-6)
    assert len(_post(tb, "/generate", {"prompt_ids": [5, 6],
                                       "max_new_tokens": 3})[
        "output_ids"]) == 3


def test_string_stop_sequences(servers):
    """``stop`` cuts the text before the first match with finish_reason
    "stop", before max_tokens, as the JAX server does; a stop that never
    matches runs to "length"; a stream never sends the stopped tokens."""
    tb, jb, _ = servers
    body = {"prompt": [5, 9, 11], "max_tokens": 8, "temperature": 0}
    full = _post(tb, "/v1/completions", body)["choices"][0]
    stop = full["text"][3:5]
    got = _post(tb, "/v1/completions", dict(body, stop=stop))["choices"][0]
    ref = _post(jb, "/v1/completions", dict(body, stop=stop))["choices"][0]
    assert (got["text"], got["token_ids"], got["finish_reason"]) == (
        ref["text"], ref["token_ids"], ref["finish_reason"])
    assert got["finish_reason"] == "stop" and stop not in got["text"]
    assert full["text"].startswith(got["text"])
    assert len(got["token_ids"]) < 8
    chunks = [e["choices"][0] for e in _sse(tb, "/v1/completions",
                                             dict(body, stop=stop))]
    assert sum((c["token_ids"] for c in chunks), []) == got["token_ids"]
    assert chunks[-1]["finish_reason"] == "stop"
    never = _post(tb, "/v1/completions", dict(body, max_tokens=4,
                                              stop=["@@@never@@@"]))
    assert never["choices"][0]["finish_reason"] == "length"


# ── CLI and loadgen ──────────────────────────────────────────────────────


def test_cli_generate_with_tokenizer_matches_jax(tmp_path, jparams, capsys):
    """``generate --prompt --tokenizer`` (a byte-level BPE saved by
    ``tokenizers`` / ``PreTrainedTokenizerFast``) with penalties, a logit
    bias and a guided regex prints the JAX CLI's JSON lines."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    from quant_tpu.checkpoint.format import save_checkpoint
    from quant_tpu.cli import main as jmain
    from quant_tpu_torch.cli import main as tmain

    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(
        ["hello world, the quick brown fox jumps over the lazy dog"] * 8,
        vocab_size=300, min_frequency=1, special_tokens=["<eos>"])
    PreTrainedTokenizerFast(tokenizer_object=bpe._tokenizer,
                            eos_token="<eos>").save_pretrained(tmp_path / "tk")
    save_checkpoint(str(tmp_path / "ckpt"), jparams, JCFG)
    argv = ["generate", str(tmp_path / "ckpt"), "--prompt", "hello world",
            "--prompt", "the lazy dog", "--tokenizer", str(tmp_path / "tk"),
            "--max-new", "6", "--slots", "2", "--max-seq", "64",
            "--repetition-penalty", "1.3", "--presence-penalty", "0.4",
            "--logit-bias", "5:-100,17:2.5", "--guided-regex", "[a-z ]{3,9}"]
    jmain(argv)
    ref = capsys.readouterr().out.splitlines()
    assert tmain(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(got) == 2
    assert all(re.fullmatch("[a-z ]{3,9}", json.loads(ln)["text"]
                            .removesuffix("<eos>")) for ln in got)


def test_loadgen_matches_jax(jax_run, tparams):
    from quant_tpu.engine import loadgen as jloadgen
    from quant_tpu_torch.engine import loadgen as tloadgen

    spec = dict(n_requests=6, rate=50.0, prompt_len=(4, 12), max_new=(2, 4),
                seed=3)
    got = tloadgen._arrivals(tloadgen.LoadSpec(**spec), V)
    ref = jloadgen._arrivals(jloadgen.LoadSpec(**spec), V)
    assert [(t, r.prompt, r.max_new_tokens) for t, r in got] == [
        (t, r.prompt, r.max_new_tokens) for t, r in ref]
    eng = TEngine(tparams, TCFG, max_slots=7, max_seq=64, eos_id=EOS,
                  device="cpu")
    rep = tloadgen.run_load(eng, tloadgen.LoadSpec(**dict(
        spec, n_requests=4, rate=1e4, block=4)))
    assert sorted(rep) == jax_run["load_keys"]
    assert rep["requests"] == 4 and rep["output_tokens"] >= 8


def test_threaded_clients_batch(servers):
    """Concurrent greedy requests with penalties batch in the engine and
    answer as they do alone."""
    tb = servers[0]
    body = lambda i: {"prompt_ids": [5 + i, 9, 11], "max_new_tokens": 5,
                      "repetition_penalty": 1.4, "presence_penalty": 0.3}
    alone = [_post(tb, "/generate", body(i))["output_ids"] for i in range(3)]
    results = {}

    def post(i):
        results[i] = _post(tb, "/generate", body(i))["output_ids"]
    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert [results[i] for i in range(3)] == alone
