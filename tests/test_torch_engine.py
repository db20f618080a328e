"""The port's engine, checkpoint format and CLI against the JAX package (CPU).

* Greedy generation through the continuous-batching engine is token-identical
  to ``quant_tpu.engine.Engine`` on ``test-tiny`` in float32, with more
  requests than slots (admission and slot reuse), through ``step`` and
  ``step_block``.
* ``quant-tpu-ckpt-v2`` checkpoints round-trip both ways, byte-equal.
* ``python -m quant_tpu_torch generate`` prints one JSON line per prompt.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.checkpoint.format import load_checkpoint as j_load
from quant_tpu.checkpoint.format import save_checkpoint as j_save
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat

REPO = pathlib.Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
TCFG = TConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    flat = _flatten_params(jax.tree.map(np.asarray, jparams))
    return params_from_flat(flat, TCFG, "cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(3, JCFG.vocab_size, n)]
            for n in (5, 11, 3, 20, 7)]


def _drive(eng, make_req, prompts, use_block):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        if use_block:
            eng.step_block(4)
        else:
            eng.step()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def jax_greedy(jparams):
    """The JAX engine's greedy outputs (``step``; greedy decoding gives the
    same tokens through ``step_block``)."""
    return _drive(JEngine(jparams, JCFG, max_slots=2, max_seq=64, eos_id=-1),
                  JRequest, _prompts(), False)


@pytest.mark.parametrize("use_block", [False, True])
def test_greedy_matches_jax_engine(jax_greedy, tparams, use_block):
    prompts = _prompts()
    eng = TEngine(tparams, TCFG, max_slots=2, max_seq=64, eos_id=-1,
                  device="cpu")
    got = _drive(eng, TRequest, prompts, use_block)
    assert got == jax_greedy
    assert all(len(o) == 6 for o in got)
    assert eng.stats["prefill_chunks"] == len(prompts)


@pytest.mark.parametrize("what", ["paged", "spec_gamma"])
def test_speculative_engine_matches_jax(jax_greedy, tparams, what):
    """Speculation, once refused, serves: the n-gram engine at gamma 2,
    contiguous or paged, gives the JAX engine's greedy streams."""
    engine_kw = {"paged": {"paged": True, "page_size": 8},
                 "spec_gamma": {}}[what]
    eng = TEngine(tparams, TCFG, max_slots=2, max_seq=64, eos_id=-1,
                  device="cpu", spec_gamma=2, **engine_kw)
    assert _drive(eng, TRequest, _prompts(), False) == jax_greedy
    st = eng.stats
    assert st["verify_forwards"] > 0 and st["decode_forwards"] == 0
    assert st["spec_tokens_per_slot_step"] >= 1.0


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_engine_features_raise(tparams, what):
    engine_kw = {"mesh": {"mesh": object()}}[what]
    with pytest.raises(NotImplementedError):
        eng = TEngine(tparams, TCFG, max_slots=1, max_seq=16, device="cpu",
                      **engine_kw)
        eng.add_request(TRequest(req_id=0, prompt=[1], max_new_tokens=1))


@pytest.mark.parametrize("what", ["embed", "fsm", "top_logprobs", "penalty",
                                  "logit_bias", "lora"])
def test_ported_engine_features_run(tparams, what):
    """The features that once raised NotImplementedError run: embeddings
    are unit vectors, an FSM forces its choice, top-logprobs lead with the
    greedy token, a penalty and a -100 bias keep the engine serving, and a
    paged, prefix-cached engine serves a request under a LoRA adapter
    (``tests/test_torch_lora.py`` holds its streams against JAX)."""
    from quant_tpu_torch.engine import SamplingConfig
    from quant_tpu_torch.engine.grammar import choice_fsm

    engine_kw = {}
    if what == "lora":
        rng = np.random.default_rng(0)
        engine_kw = dict(paged=True, page_size=8, prefix_cache=True, loras={
            "a": {"layers.0.wq.a": rng.standard_normal(
                (TCFG.dim, 2)).astype(np.float32),
                  "layers.0.wq.b": rng.standard_normal(
                (2, TCFG.n_heads * TCFG.head_dim)).astype(np.float32)}})
    eng = TEngine(tparams, TCFG, max_slots=1, max_seq=16, eos_id=7,
                  device="cpu", **engine_kw)
    if what == "embed":
        v = eng.embed([1, 2])
        assert v.shape == (TCFG.dim,)
        assert abs(float(np.linalg.norm(v)) - 1.0) < 1e-5
        return
    request_kw = {"fsm": {"fsm": choice_fsm([[5, 6]], TCFG.vocab_size, 7)},
                  "top_logprobs": {"top_logprobs": 2},
                  "penalty": {"sampling": SamplingConfig(
                      repetition_penalty=1.1)},
                  "logit_bias": {"sampling": SamplingConfig(
                      logit_bias=((1, -100.0),))},
                  "lora": {"lora": "a"}}[what]
    req = TRequest(req_id=0, prompt=[1, 2], max_new_tokens=4, **request_kw)
    eng.add_request(req)
    while eng.has_work():
        eng.step()
    assert req.finished and 1 <= len(req.output) <= 4
    if what == "fsm":
        assert req.output == [5, 6, 7]
    if what == "top_logprobs":
        assert [t[0] for t in req.top_ids] == req.output
    if what == "logit_bias":
        assert 1 not in req.output
    if what == "lora":
        assert eng.stats["loras"] == 1 and eng.lora_names["a"] == 1


def test_prefix_cache_requires_paged(tparams):
    with pytest.raises(ValueError, match="paged"):
        TEngine(tparams, TCFG, max_slots=1, max_seq=16, device="cpu",
                prefix_cache=True)


def test_filter_logits_and_logprob_match_jax():
    """Per-slot temperature / top-k / top-p / min-p masks select the same
    tokens as the JAX sampler, with the same scaled logits; token_logprob
    agrees. (Draws differ: each side has its own generator.)"""
    import jax.numpy as jnp

    from quant_tpu.engine import sampler as jsampler
    from quant_tpu_torch.engine import sampler as tsampler

    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(tsampler.SamplingConfig) == fields(jsampler.SamplingConfig)
    rng = np.random.default_rng(4)
    lg = (rng.standard_normal((5, 300)) * 3).astype(np.float32)
    knobs = [np.asarray(v, dt) for v, dt in (
        ([0.7, 1.0, 1.3, 0.5, 1.0], np.float32),    # temperature
        ([0, 20, 0, 5, 50], np.int32),               # top_k
        ([1.0, 1.0, 0.8, 0.9, 0.5], np.float32),     # top_p
        ([0.0, 0.0, 0.0, 0.1, 0.05], np.float32))]   # min_p
    ref = np.asarray(jsampler.filter_logits(jnp.asarray(lg),
                                            *map(jnp.asarray, knobs)))
    got = tsampler.filter_logits(torch.from_numpy(lg),
                                 *map(torch.from_numpy, knobs)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    keep = ~np.isinf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)
    toks = rng.integers(0, 300, 5).astype(np.int32)
    np.testing.assert_allclose(
        tsampler.token_logprob(torch.from_numpy(lg),
                               torch.from_numpy(toks)).numpy(),
        np.asarray(jsampler.token_logprob(jnp.asarray(lg),
                                          jnp.asarray(toks))),
        rtol=1e-5, atol=1e-6)


def _leaves(flat):
    """name -> list of numpy arrays (codes/scales of quantized leaves)."""
    out = {}
    for name, leaf in flat.items():
        parts = ([leaf.codes, leaf.scales] if hasattr(leaf, "codes")
                 else [leaf])
        out[name] = [p.numpy() if isinstance(p, torch.Tensor)
                     else np.asarray(p) for p in parts]
    return out


def _assert_same_bytes(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        for x, y in zip(a[name], b[name]):
            assert x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


def test_checkpoint_round_trips_both_ways(tmp_path, jparams, tparams):
    j_save(tmp_path / "j", jparams, JCFG)
    loaded, cfg = t_load(tmp_path / "j", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JCFG)
    _assert_same_bytes(_leaves(flat_from_params(loaded)),
                       _leaves(_flatten_params(jax.tree.map(np.asarray,
                                                            jparams))))
    t_save(tmp_path / "t", tparams, TCFG)
    jloaded, jcfg = j_load(tmp_path / "t", device=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(TCFG)
    _assert_same_bytes(_leaves(_flatten_params(jax.tree.map(np.asarray,
                                                            jloaded))),
                       _leaves(flat_from_params(tparams)))


def test_checkpoint_bf16_embed_round_trip(tmp_path):
    """test-tiny in bfloat16 keeps a bf16 embedding table (embed_bits 16)."""
    cfg = TConfig(**dataclasses.asdict(JPRESETS["test-tiny"]))
    jp = jllama.init_params(JPRESETS["test-tiny"], seed=1)
    j_save(tmp_path / "j", jp, JPRESETS["test-tiny"])
    tp, _ = t_load(tmp_path / "j", device="cpu")
    assert tp.embed.dtype == torch.bfloat16
    t_save(tmp_path / "t", tp, cfg)
    jp2, _ = j_load(tmp_path / "t", device=False)
    np.testing.assert_array_equal(
        np.asarray(jp2.embed).view(np.uint16),
        np.asarray(jp.embed).view(np.uint16))


def test_checkpoint_files_byte_equal_to_jax(tmp_path, jparams, tparams):
    """The streaming ``CheckpointWriter`` behind ``save_checkpoint`` writes
    ``manifest.json`` (shard axes included) and ``data.bin`` byte for byte
    as the JAX writer does; tp>1 packing is refused."""
    from quant_tpu_torch.checkpoint.format import CheckpointWriter

    j_save(tmp_path / "j", jparams, JCFG)
    t_save(tmp_path / "t", tparams, TCFG)
    for name in ("manifest.json", "data.bin"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    with pytest.raises(NotImplementedError, match="tp>1"):
        CheckpointWriter(tmp_path / "x", TCFG, tp=2)


def test_cli_generate_prints_json_lines(tmp_path, tparams):
    t_save(tmp_path / "ckpt", tparams, TCFG)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "quant_tpu_torch", "generate",
         str(tmp_path / "ckpt"), "--prompt-ids", "5,6,7;8,9", "--max-new",
         "4", "--slots", "2", "--max-seq", "32", "--eos-id", "-1",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["prompt"] for x in lines] == [[5, 6, 7], [8, 9]]
    eng = TEngine(tparams, TCFG, max_slots=2, max_seq=32, eos_id=-1,
                  device="cpu")
    assert [x["output"] for x in lines] == eng.generate(
        [[5, 6, 7], [8, 9]], max_new_tokens=4)
