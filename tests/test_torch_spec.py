"""The port's speculative engine against the JAX reference (CPU).

* The engine: speculative greedy streams equal the port's plain greedy
  streams token for token on test-tiny f32 (n-gram contiguous, paged,
  prefix-cached, test-tiny-mla, the ``max_seq`` boundary, EOS and
  ``max_new``, penalties, bias, a choice grammar, top logprobs, LoRA), each
  with accepted drafts; a parked slot's verify writes stay on the scratch
  page while a prefix-cached admission prefills; a contiguous n-gram run
  and a draft-model run have the JAX engine's streams and its
  ``spec_proposed`` / ``spec_accepted`` (one module-scoped JAX run). The
  plain engine is held to JAX in ``test_torch_engine.py`` and
  ``test_torch_serving_api.py``; the proposer and ``spec_commit`` in
  ``test_torch_spec_commit.py``.
* The draft-model proposer: streams equal plain greedy, identical weights
  accept everything, staggered admission, a paged target and a sampled
  slot; its refusals with JAX's messages.
* ``serve --spec-gamma`` and ``--draft-ckpt`` build the engine (the server
  call replaced), and ``--draft-ckpt`` alone exits with JAX's message.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine.spec import DraftModelProposer as JDraft
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.engine import SamplingConfig as TSampling
from quant_tpu_torch.engine import grammar as tgrammar
from quant_tpu_torch.engine.spec import DraftModelProposer as TDraft
from quant_tpu_torch.engine.spec import NgramProposer as TNgram
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

JCFG = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
TCFG = TConfig(**dataclasses.asdict(JCFG))
V = JCFG.vocab_size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tparams(seed, cfg=TCFG):
    return tllama.init_params(cfg, seed=seed, device="cpu")


def _repetitive(seed, n=3):
    """JAX's prompts: a 4-token motif twice and its first two again."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        motif = [int(t) for t in rng.integers(3, V, 4)]
        out.append(motif + motif + motif[:2])
    return out


def _run(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


# ── the engine against the plain engine ─────────────────────────────────


def _fsm():
    return tgrammar.choice_fsm([[30, 31, 32, 33, 34, 35]], V, 500)


_ENGINE_CASES = {
    # name: (engine kwargs, prompts, request kwargs, max_new, params)
    "contiguous": ({}, _repetitive(11), {}, 10, 11),
    "paged": ({"paged": True, "page_size": 8}, _repetitive(11), {}, 10, 11),
    "prefix": ({"paged": True, "page_size": 8, "prefix_cache": True},
               [[7, 8, 9, 10, 7, 8, 9, 10] + p for p in _repetitive(12)],
               {}, 10, 12),
    "max_seq": ({"max_seq": 16}, [[5, 6, 7, 5, 6, 7, 5, 6]], {}, 8, 35),
    # penalties that favour repetition, so n-gram drafts get accepted and
    # the in-window counts decide the chain
    "penalties": ({}, _repetitive(12, 2),
                  {"sampling": TSampling(repetition_penalty=0.9,
                                         frequency_penalty=-0.2,
                                         presence_penalty=0.1)}, 8, 12),
    "bias": ({}, _repetitive(15, 2),
             {"sampling": TSampling(logit_bias=((100, -1e9), (200, 5.0)))},
             8, 15),
    "fsm": ({"eos_id": 500}, [[30, 31, 32, 33, 34, 35, 30, 31]],
            {"fsm": "choice"}, 8, 5),
    "top_logprobs": ({}, _repetitive(20, 2), {"top_logprobs": 3}, 8, 20),
}


def _engine_run(params, cfg, engine_kw, prompts, req_kw, max_new, **kw):
    ekw = {"max_slots": 4, "max_seq": 64, "eos_id": -1, **engine_kw, **kw}
    eng = TEngine(params, cfg, device="cpu", **ekw)
    fsm = _fsm() if req_kw.get("fsm") else None
    reqs = [TRequest(req_id=i, prompt=list(p), max_new_tokens=max_new,
                     **{**req_kw, "fsm": fsm}) for i, p in enumerate(prompts)]
    _run(eng, reqs)
    return reqs, eng.stats


@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_spec_engine_matches_plain_greedy(case):
    """gamma=4 n-gram speculation against the plain engine on the same
    requests: the same tokens, drafts accepted, and every page back in a
    paged pool; the logprobs and top-logprobs within 1e-3 (the verify's
    matmuls at M = B(g+1) round otherwise than the decode's at M = B, which
    can move a KV code at a rounding tie by one). The seeds are ones whose
    random models repeat themselves, so drafts are accepted."""
    engine_kw, prompts, req_kw, max_new, seed = _ENGINE_CASES[case]
    params = _tparams(seed)
    plain, _ = _engine_run(params, TCFG, engine_kw, prompts, req_kw, max_new)
    spec, st = _engine_run(params, TCFG, engine_kw, prompts, req_kw, max_new,
                           spec_gamma=4)
    assert [r.output for r in spec] == [r.output for r in plain]
    assert st["spec_accepted"] > 0 and st["verify_forwards"] > 0, st
    assert st["decode_forwards"] == 0
    for p, s in zip(plain, spec):
        np.testing.assert_allclose(s.logprobs, p.logprobs, rtol=0, atol=1e-3)
        assert s.top_ids == p.top_ids
        np.testing.assert_allclose(np.asarray(s.top_lps, np.float32),
                                   np.asarray(p.top_lps, np.float32),
                                   rtol=0, atol=1e-3)
    if "paged" in engine_kw:
        assert st["free_pages"] + st.get("cached_blocks", 0) == \
            st["total_pages"]
    if case == "prefix":
        assert st["prefix_hit_tokens"] == 2 * 8
    if case == "fsm":
        assert spec[0].output == [30, 31, 32, 33, 34, 35, 500]
    if case == "top_logprobs":
        assert all(len(r.top_ids) == max_new for r in spec)


def test_spec_admission_in_progress_never_writes_shared_pages():
    """The scratch-page guard under speculation: while a prefix-cached
    admission prefills its suffix over three chunks, the other slot keeps
    verifying, and the admitting slot's device table row stays parked on
    page 0, so the verify's T=5 writes for it never reach the shared prefix
    pages: both streams equal a contiguous plain engine's."""
    params = _tparams(9)
    rng = np.random.default_rng(9)
    sys_prompt = [int(t) for t in rng.integers(3, V, 16)]
    a = sys_prompt + [7, 9, 11]
    b = sys_prompt + [int(x) for x in rng.integers(3, 99, 20)]
    eng = TEngine(params, TCFG, max_slots=2, max_seq=64, eos_id=-1,
                  paged=True, page_size=8, prefix_cache=True, device="cpu",
                  spec_gamma=4)
    eng.PREFILL_CHUNK = 8          # b's 20-token suffix takes three chunks
    ra = TRequest(req_id=0, prompt=a, max_new_tokens=24)
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
    assert eng.stats["prefix_hit_tokens"] == 2 * 8
    assert [ra.output, rb.output] == [_plain(params, a, 24),
                                      _plain(params, b, 6)]


def test_spec_engine_mla_eos_and_max_new():
    """test-tiny-mla (a latent cache) speculative against plain; on
    test-tiny an EOS inside an accepted run ends the stream there, and a
    max_new_tokens=1 request commits one token."""
    mcfg = dataclasses.replace(TConfig(**dataclasses.asdict(
        JPRESETS["test-tiny-mla"])), dtype="float32")
    params = _tparams(6, mcfg)
    prompts = _repetitive(6, 2)
    plain, _ = _engine_run(params, mcfg, {}, prompts, {}, 8)
    spec, st = _engine_run(params, mcfg, {}, prompts, {}, 8, spec_gamma=4)
    assert [r.output for r in spec] == [r.output for r in plain]
    assert st["spec_accepted"] > 0, st

    params = _tparams(14)
    (ref,), _ = _engine_run(params, TCFG, {"max_slots": 1},
                            [[5, 6, 7, 5, 6, 7]], {}, 6)
    eos = ref.output[2]
    (r,), st = _engine_run(params, TCFG, {"max_slots": 1, "eos_id": eos},
                           [[5, 6, 7, 5, 6, 7]], {}, 20, spec_gamma=4)
    assert r.output == ref.output[:3]
    (r,), _ = _engine_run(params, TCFG, {"max_slots": 1}, [[5, 6, 7]], {}, 1,
                          spec_gamma=4)
    assert r.finished and len(r.output) == 1


def test_spec_engine_lora_ngram():
    """n-gram speculation under a LoRA adapter: the plain adapter stream,
    which differs from the base model's."""
    from test_lora import _adapter

    params = _tparams(95)
    ads = {"a": _adapter(JCFG, 96, r=4)}
    prompts = _repetitive(97, 2)
    plain, _ = _engine_run(params, TCFG, {"loras": ads}, prompts,
                           {"lora": "a"}, 8)
    spec, st = _engine_run(params, TCFG, {"loras": ads}, prompts,
                           {"lora": "a"}, 8, spec_gamma=4)
    base, _ = _engine_run(params, TCFG, {}, prompts, {}, 8, spec_gamma=4)
    assert [r.output for r in spec] == [r.output for r in plain]
    assert [r.output for r in base] != [r.output for r in plain]
    assert st["spec_accepted"] > 0, st


# ── stats against the JAX engine ────────────────────────────────────────


def _flat(jparams):
    return _flatten_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def jax_spec():
    """The JAX engine, gamma=4, driven with step(): n-gram drafts on JAX's
    repetitive prompts, and a draft model of other weights on random
    prompts; the streams and the spec stats of each."""
    jp, jd = jllama.init_params(JCFG, seed=11), jllama.init_params(JCFG,
                                                                    seed=99)
    rng = np.random.default_rng(41)
    runs = {"ngram": (_repetitive(11), None),
            "draft": ([[int(t) for t in rng.integers(3, V, n)]
                       for n in (5, 11, 3)], jd)}
    from quant_tpu.engine import Request as JRequest

    res = {}
    for name, (prompts, draft) in runs.items():
        prop = (JDraft(draft, JCFG, gamma=4, max_slots=4, max_seq=64)
                if draft is not None else None)
        eng = JEngine(jp, JCFG, max_slots=4, max_seq=64, eos_id=-1,
                      spec_gamma=4, spec_proposer=prop)
        outs = _run(eng, [JRequest(req_id=i, prompt=p, max_new_tokens=10)
                          for i, p in enumerate(prompts)])
        res[name] = (prompts, outs, {k: eng.stats[k] for k in (
            "spec_proposed", "spec_accepted")})
    return {"params": _flat(jp), "draft": _flat(jd), "runs": res}


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
def test_spec_stats_match_jax_engine(jax_spec, proposer):
    """The same params and prompts through the port's engine: JAX's streams
    and its spec_proposed / spec_accepted exactly."""
    prompts, outs, stats = jax_spec["runs"][proposer]
    params = params_from_flat(jax_spec["params"], TCFG, "cpu")
    prop = None
    if proposer == "draft":
        prop = TDraft(params_from_flat(jax_spec["draft"], TCFG, "cpu"), TCFG,
                      gamma=4, max_slots=4, max_seq=64, device="cpu")
    eng = TEngine(params, TCFG, max_slots=4, max_seq=64, eos_id=-1,
                  device="cpu", spec_gamma=4, spec_proposer=prop)
    got = _run(eng, [TRequest(req_id=i, prompt=p, max_new_tokens=10)
                     for i, p in enumerate(prompts)])
    assert got == outs
    assert {k: eng.stats[k] for k in stats} == stats
    assert stats["spec_proposed"] > 0


# ── the draft-model proposer ────────────────────────────────────────────


def _draft_engine(params, draft, gamma=4, slots=2, **kw):
    prop = TDraft(draft, TCFG, gamma=gamma, max_slots=slots, max_seq=64,
                  device="cpu")
    return TEngine(params, TCFG, max_slots=slots, max_seq=64, eos_id=-1,
                   device="cpu", spec_gamma=gamma, spec_proposer=prop, **kw)


def _plain(params, prompt, n):
    eng = TEngine(params, TCFG, max_slots=1, max_seq=64, eos_id=-1,
                  device="cpu")
    return eng.generate([prompt], max_new_tokens=n)[0]


@pytest.mark.parametrize("case", ["identical", "staggered", "paged",
                                  "sampled"])
def test_draft_model_proposer(case):
    """Identical weights accept every draft (4 + 1 tokens a slot step);
    other weights with a request admitted mid-run, or over a paged target,
    keep plain greedy; a sampled slot beside a greedy one (identical
    weights): the greedy stream exact, the sampled one reproducible from its
    seed, nearly every sampled draft accepted."""
    params = _tparams(42)
    other = params if case in ("identical", "sampled") else _tparams(43)
    eng = _draft_engine(params, other, **(
        {"paged": True, "page_size": 8} if case == "paged" else {}))
    p1, p2 = [5, 6, 7, 8, 5, 6, 7], [9, 8, 7, 6, 9]
    if case == "sampled":
        def run():
            e = _draft_engine(params, params)
            rs = TRequest(req_id=1, prompt=p2, max_new_tokens=10, seed=123,
                          sampling=TSampling(temperature=1.0))
            rg = TRequest(req_id=0, prompt=p1, max_new_tokens=8)
            _run(e, [rg, rs])
            return rg.output, rs.output, e.stats
        g1, s1, st = run()
        assert g1 == _plain(params, p1, 8)
        assert len(s1) == 10 and run()[:2] == (g1, s1)
        assert st["spec_acceptance"] > 0.9, st
        return
    r1 = TRequest(req_id=0, prompt=p1, max_new_tokens=11)
    r2 = TRequest(req_id=1, prompt=p2, max_new_tokens=9)
    eng.add_request(r1)
    if case == "staggered":
        eng.step()
        eng.step()
    _run(eng, [r2])
    assert r1.output == _plain(params, p1, 11)
    assert r2.output == _plain(params, p2, 9)
    st = eng.stats
    if case == "identical":
        assert st["spec_accepted"] == st["spec_proposed"] > 0, st
        assert st["spec_tokens_per_slot_step"] >= 4.0, st
    if case == "paged":
        assert st["free_pages"] == st["total_pages"]


@pytest.mark.parametrize("case", ["lora", "gamma"])
def test_draft_model_refusals(case):
    """A draft model beside LoRA adapters, and a proposer whose gamma is
    below the engine's, raise JAX's ValueErrors."""
    from test_lora import _adapter

    params = _tparams(1)
    prop = TDraft(params, TCFG, gamma=2, max_slots=2, max_seq=64,
                  device="cpu")
    if case == "lora":
        with pytest.raises(ValueError, match="draft-MODEL proposer"):
            TEngine(params, TCFG, max_slots=2, max_seq=64, device="cpu",
                    loras={"a": _adapter(JCFG, 2, r=2)}, spec_gamma=2,
                    spec_proposer=prop)
    else:
        with pytest.raises(ValueError, match="proposer gamma 2 < engine "
                                             "spec_gamma 3"):
            TEngine(params, TCFG, max_slots=2, max_seq=64, device="cpu",
                    spec_gamma=3, spec_proposer=prop)


# ── the CLI ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("case", ["ngram", "draft", "no-gamma",
                                  "vocab"])
def test_cli_serve_spec_flags(tmp_path, monkeypatch, case):
    """``serve --spec-gamma 4`` (n-gram) and ``--draft-ckpt`` build a
    speculative engine (the server call replaced); ``--draft-ckpt`` without
    ``--spec-gamma`` and a draft of another vocabulary exit with JAX's
    messages."""
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.cli import main
    from quant_tpu_torch.engine import server

    save_checkpoint(tmp_path / "t", _tparams(0), TCFG)
    dcfg = TCFG if case != "vocab" else dataclasses.replace(TCFG,
                                                            vocab_size=384)
    save_checkpoint(tmp_path / "d", _tparams(1, dcfg), dcfg)
    seen = {}
    monkeypatch.setattr(server, "serve",
                        lambda eng, **kw: seen.update(eng=eng, **kw))
    argv = ["serve", str(tmp_path / "t"), "--slots", "2", "--max-seq", "64",
            "--device", "cpu"]
    if case == "ngram":
        assert main(argv + ["--spec-gamma", "4"]) == 0
        eng = seen["eng"]
        assert eng.spec_gamma == 4 and isinstance(eng.proposer, TNgram)
        assert eng.generate([[5, 6, 5, 6, 5]], max_new_tokens=4)[0]
        return
    draft = ["--draft-ckpt", str(tmp_path / "d")]
    if case == "draft":
        assert main(argv + ["--spec-gamma", "4"] + draft) == 0
        eng = seen["eng"]
        assert isinstance(eng.proposer, TDraft)
        assert eng.proposer.gamma == 4 and eng.proposer.max_seq == 64
        return
    msg = ("--draft-ckpt requires --spec-gamma > 0" if case == "no-gamma"
           else f"draft vocab 384 != target {V} (same tokenizer required)")
    with pytest.raises(SystemExit, match=msg.replace("(", r"\(").replace(
            ")", r"\)")):
        main(argv + draft + ([] if case == "no-gamma"
                             else ["--spec-gamma", "2"]))
    assert "eng" not in seen
