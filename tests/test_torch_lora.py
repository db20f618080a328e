"""The port's multi-LoRA serving against the JAX reference (CPU).

* The stack: ``make_lora_stack``'s arrays byte-equal to JAX's (GQA,
  test-tiny-mla, test-tiny-dsv3 with its dense-prefix MLP, layer-varying
  rank), its refusals with JAX's messages; ``lora_delta`` within 1e-5 of
  JAX's, the base rows exactly 0.
* The forward with mixed ``adapter_ids`` against JAX's jitted forward on
  test-tiny (GQA, int8 cache) and test-tiny-dsv3 (MLA, MoE with a dense
  prefix), contiguous and paged, at ``test_torch_llama.py``'s tolerances:
  logits within 1e-4 of max|logit|, 1e-3 from a slot's first KV code that
  differs from JAX's (a rounding tie). The JAX reference indexes a
  ``first_k_dense`` model's LoRA rows by the position in each layer stack
  (global layer ``k0 + j`` reads row ``j``); the port by the global layer.
  So the port's adapter carries the same attention A/B (X0) at layers 0 and
  1 and X2 at layer 2, and JAX's rows {0: X0, 1: X2}: both then apply X0,
  X0, X2. An adapter on the last layer alone must move the port's logits.
* The engine (base and two adapters co-batched, contiguous and paged with a
  prefix cache) token-identical to the JAX engine; the prefix cache keys
  name the adapter (the JAX engine's keys do not, and a base request there
  reuses an adapter's pages).
* ``load_hf_adapter`` through the port's safetensors reader equal to JAX's
  dict; the server's ``lora`` and ``model`` routing, the chat and streamed
  paths, ``/v1/models`` and the 400 of an unknown adapter against the JAX
  server over the same engine run; ``generate --lora --use-lora`` printing
  the JAX CLI's lines (the JAX CLI prints ``{"prompt", "output"}`` of its
  engine's greedy stream, the JAX engine run's here).

One module-scoped JAX forward run and one JAX engine run (driven with
``step()``, so the JAX server reuses its programs).
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_lora import CFG as JCFG
from test_lora import _adapter, _mla_adapter

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu.models import lora as jlora
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models import lora as tlora
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import lora_from_leaves, params_from_flat

_OPEN = urllib.request.build_opener(urllib.request.ProxyHandler({})).open
_LEAVES = ("a_qkv", "b_qkv", "a_o", "b_o", "a_gu", "b_gu", "a_down",
           "b_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jc):
    return TConfig(**dataclasses.asdict(jc))


def _flat(jparams):
    return _flatten_params(jax.tree.map(np.asarray, jparams))


def _dsv3_mlp(cfg):
    di = cfg.dense_intermediate
    return (("w_gate", cfg.dim, di), ("w_up", cfg.dim, di),
            ("w_down", di, cfg.dim))


def _prefix_only(ad, cfg):
    """Drop the MLP entries of the MoE layers (only the dense prefix's MLP
    takes an adapter)."""
    return {k: v for k, v in ad.items()
            if not (any(f".{p}." in k for p in ("w_gate", "w_up", "w_down"))
                    and int(k.split(".")[1]) >= cfg.first_k_dense)}


def _varying_rank(cfg):
    """Layer 1's wq at rank 4, layer 0's wk at rank 2, nothing else."""
    rng = np.random.default_rng(90)
    d, hd = cfg.dim, cfg.head_dim
    return {"alpha": 8.0,
            "layers.1.wq.a": rng.standard_normal((d, 4)).astype(np.float32),
            "layers.1.wq.b": rng.standard_normal(
                (4, cfg.n_heads * hd)).astype(np.float32),
            "layers.0.wk.a": rng.standard_normal((d, 2)).astype(np.float32),
            "layers.0.wk.b": rng.standard_normal(
                (2, cfg.n_kv_heads * hd)).astype(np.float32)}


def _stack_inputs(name):
    if name == "gqa":
        cfg = JCFG
        return cfg, [_adapter(cfg, 1, r=2), _adapter(cfg, 2, r=3)]
    if name == "varying-rank":
        return JCFG, [_varying_rank(JCFG), _adapter(JCFG, 3, r=1)]
    cfg = JPRESETS["test-tiny-mla" if name == "mla" else "test-tiny-dsv3"]
    extra = _dsv3_mlp(cfg) if name == "dsv3" else ()
    ads = [_prefix_only(_mla_adapter(cfg, s, r=r, extra=extra), cfg)
           for s, r in ((4, 2), (5, 3))]
    return cfg, ads


# ── stack and delta ─────────────────────────────────────────────────────


@pytest.mark.parametrize("name", ["gqa", "mla", "dsv3", "varying-rank"])
def test_stack_matches_jax(name):
    cfg, ads = _stack_inputs(name)
    ref = jlora.make_lora_stack(ads, cfg)
    got = tlora.make_lora_stack(ads, _tcfg(cfg), device="cpu")
    assert got.n_adapters == ref.n_adapters == len(ads) + 1
    for f in _LEAVES:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape, f
        assert np.ascontiguousarray(g).tobytes() == r.tobytes(), f
    carried = lora_from_leaves(ref, "cpu")
    for f in _LEAVES:
        assert torch.equal(getattr(carried, f), getattr(got, f)), f


def _bad(case):
    cfg = dataclasses.replace(JPRESETS["test-tiny-dsv3"], bits=8,
                              group_size=64)
    if case == "moe-mlp":
        ad = _mla_adapter(cfg, 11, extra=_dsv3_mlp(cfg))
    elif case == "absorbed":
        ad = _prefix_only(_mla_adapter(cfg, 11), cfg)
        ad["layers.0.wkv_b.a"] = np.zeros((4, 1), np.float32)
        ad["layers.0.wkv_b.b"] = np.zeros((1, 4), np.float32)
    else:
        cfg = JCFG
        ad = _adapter(cfg, 12)
        ad["layers.1.wo.b"] = ad["layers.1.wo.b"][:, :-1]
    return cfg, [ad]


@pytest.mark.parametrize("case", ["moe-mlp", "absorbed", "shape"])
def test_stack_refusals_match_jax(case):
    cfg, ads = _bad(case)
    with pytest.raises(ValueError) as ref:
        jlora.make_lora_stack(ads, cfg)
    with pytest.raises(ValueError) as got:
        tlora.make_lora_stack(ads, _tcfg(cfg), device="cpu")
    assert str(got.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="queue 1 #8"):
        tlora.make_lora_stack(_stack_inputs("gqa")[1], _tcfg(JCFG), tp=2,
                              device="cpu")


def test_lora_delta_matches_jax():
    """At layer 1, ids [0, 1, 2, 2, 1]: the fused qkv delta (block-diagonal
    B) and the down delta (the MLP's K) within 1e-5 of JAX's masked sum;
    every group's base slot exactly 0, and ``out=`` adding the delta to an
    f32 output through one addmm."""
    cfg, ads = _stack_inputs("gqa")
    js = jlora.make_lora_stack(ads, cfg)
    ts = tlora.make_lora_stack(ads, _tcfg(cfg), device="cpu")
    ids = np.array([0, 1, 2, 2, 1], np.int32)
    rng = np.random.default_rng(0)
    batch = tlora.LoraBatch.of(ts, torch.from_numpy(ids))
    for g in tlora.GROUPS:
        k = getattr(ts, f"a_{g}").shape[2]
        x = rng.standard_normal((5, 3, k)).astype(np.float32)
        got = tlora.lora_delta(torch.from_numpy(x), getattr(ts, f"a_{g}"),
                               getattr(ts, f"b_{g}"), 1,
                               torch.from_numpy(ids)).numpy()
        if g in ("qkv", "down"):
            ref = np.asarray(jlora.lora_delta(
                jnp.asarray(x), getattr(js, f"a_{g}"), getattr(js, f"b_{g}"),
                1, jnp.asarray(ids)))
            assert np.max(np.abs(got - ref)) <= 1e-5, g
        assert not got[0].any() and got[1:].any(), g
        y = torch.from_numpy(rng.standard_normal(got.shape).astype(
            np.float32))
        summed = batch.delta(g, torch.from_numpy(x), 1, out=y)
        assert torch.allclose(summed, y + torch.from_numpy(got), rtol=0,
                              atol=1e-5), g


# ── forward ─────────────────────────────────────────────────────────────

B, T, STEPS, MAX_SEQ = 4, 10, 3, 32
IDS = np.array([1, 0, 2, 1], np.int32)


def _fwd_setup(name):
    """(JAX config, JAX params, JAX adapters, port adapters). On
    test-tiny-dsv3 the JAX adapters hold X0 at layer 0 and X2 at layer 1,
    the port's X0 at layers 0 and 1 and X2 at layer 2 (the module
    docstring), each with the dense prefix's MLP at layer 0."""
    if name == "gqa":
        jc = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
        ads = [_adapter(jc, 21, r=3), _adapter(jc, 22, r=2)]
        return jc, jllama.init_params(jc, seed=3), ads, ads
    jc = dataclasses.replace(JPRESETS["test-tiny-dsv3"], dtype="float32")
    attn, mlp = ("wq", "wkv_a", "wo"), ("w_gate", "w_up", "w_down")
    j_ads, t_ads = [], []
    for seed in (23, 24):
        src = _mla_adapter(jc, seed, r=3, extra=_dsv3_mlp(jc))

        def at(i, projs):
            return {k.split(".", 2)[2]: v for k, v in src.items()
                    if k.startswith(f"layers.{i}.")
                    and k.split(".")[2] in projs}

        def put(rows):
            return {"alpha": src["alpha"], **{
                f"layers.{i}.{k}": v for i, part in rows
                for k, v in part.items()}}
        x0, x2, m0 = at(0, attn), at(2, attn), at(0, mlp)
        j_ads.append(put([(0, x0), (0, m0), (1, x2)]))
        t_ads.append(put([(0, x0), (0, m0), (1, x0), (2, x2)]))
    return jc, jllama.init_params(jc, seed=3), j_ads, t_ads


def _fwd_tokens(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (B, T)).astype(np.int32)] + [
        rng.integers(0, vocab, (B, 1)).astype(np.int32)
        for _ in range(STEPS)]


_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def jax_forward():
    """name -> the JAX config, flat params, the port's adapters, the
    logits per call and the K / V codes."""
    out = {}
    for name in ("gqa", "dsv3"):
        jc, jp, j_ads, t_ads = _fwd_setup(name)
        jpl = dataclasses.replace(jp, lora=jlora.make_lora_stack(j_ads, jc))
        cache = jllama.init_cache(jc, B, MAX_SEQ)
        logits = []
        for tok in _fwd_tokens(jc.vocab_size):
            lg, cache = _jit_forward(jpl, jnp.asarray(tok), cache, cfg=jc,
                                     adapter_ids=jnp.asarray(IDS))
            logits.append(np.asarray(lg, np.float32))
        out[name] = {"cfg": jc, "jparams": jp, "flat": _flat(jp),
                     "adapters": t_ads,
                     "logits": logits, "codes": [np.asarray(cache.k_codes),
                                                 np.asarray(cache.v_codes)]}
    return out


def _pool_rows(codes, tbl):
    """A pool's code rows gathered per slot: [L, B, H, S, D]."""
    g = codes[:, tbl].permute(0, 1, 3, 2, 4, 5)   # [L, B, H, n, page, D]
    sh = g.shape
    return g.reshape(sh[0], sh[1], sh[2], sh[3] * sh[4], sh[5])


def _port_forward(run, paged, mode):
    jc = run["cfg"]
    tc = dataclasses.replace(_tcfg(jc), kernel_mode=mode)
    params = dataclasses.replace(
        params_from_flat(run["flat"], tc, "cpu"),
        lora=tlora.make_lora_stack(run["adapters"], tc, device="cpu"))
    if paged:
        # 4 pages of 8 a slot, in shuffled order
        cache = tllama.init_paged_cache(tc, B, MAX_SEQ, 1 + 4 * B, 8,
                                        device="cpu")
        perm = np.random.default_rng(1).permutation(4 * B) + 1
        cache.page_tbl.copy_(torch.from_numpy(perm.reshape(B, 4)))
    else:
        cache = tllama.init_cache(tc, B, MAX_SEQ, "cpu")
    logits = []
    for tok in _fwd_tokens(jc.vocab_size):
        lg, cache = tllama.forward(params, torch.from_numpy(tok), cache, tc,
                                   adapter_ids=torch.from_numpy(IDS),
                                   device="cpu")
        logits.append(lg.numpy())
    if paged:
        return logits, [_pool_rows(c, cache.page_tbl.long()).numpy()
                        for c in (cache.k_codes, cache.v_codes)]
    return logits, [cache.k_codes.numpy(), cache.v_codes.numpy()]


@pytest.mark.parametrize("name", ["gqa", "dsv3"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_forward_matches_jax(jax_forward, name, paged):
    """Mixed adapter ids through prefill and three decode steps, in the
    port's plain mode and its kernel mode (the wrappers' plain versions on
    the CPU), held to JAX's logits with the rounding-tie rule."""
    run = jax_forward[name]
    ref, (jk, jv) = run["logits"], run["codes"]
    for mode in ("xla", "auto"):
        got, (tk, tv) = _port_forward(run, paged, mode)
        diff = np.zeros((B, MAX_SEQ), bool)
        for a, b in ((jk, tk), (jv, tv)):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max(initial=0) <= 1, mode
            assert d.size == 0 or np.mean(d > 0) <= 1e-3, mode
            diff |= (d > 0).any(axis=(0, 2, 4))
        tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref, got):
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            tol = np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
            assert np.all(err <= tol), (mode, err)
            pos0 += r.shape[1]


def test_last_layer_adapter_moves_the_logits(jax_forward):
    """test-tiny-dsv3: an adapter whose only non-zero block is ``wo`` of the
    last layer (global layer 2, the MoE stack's second) changes the port's
    logits of its slots, and no other slot's. The JAX reference reads that
    layer's LoRA row at its stack position 1 (layer 1's zeros) and leaves
    its logits as they were: the fault the port keeps out. (The adapters
    keep the forward fixture's ranks, so the JAX forward reuses its
    compiled program.)"""
    run = jax_forward["dsv3"]
    jc = run["cfg"]
    tc = _tcfg(jc)
    last = jc.n_layers - 1
    src = _mla_adapter(jc, 31, r=3, extra=_dsv3_mlp(jc))
    ads = [{k: v if k.startswith(f"layers.{last}.wo.") or k == "alpha"
            else np.zeros_like(v) for k, v in _prefix_only(src, jc).items()},
           {k: v if k == "alpha" else np.zeros_like(v)
            for k, v in _prefix_only(src, jc).items()}]
    tok = _fwd_tokens(jc.vocab_size)[0]
    base_ids = np.zeros_like(IDS)
    jpl = dataclasses.replace(run["jparams"],
                              lora=jlora.make_lora_stack(ads, jc))
    ref = [np.asarray(_jit_forward(jpl, jnp.asarray(tok), jllama.init_cache(
        jc, B, MAX_SEQ), cfg=jc, adapter_ids=jnp.asarray(ids))[0])
        for ids in (IDS, base_ids)]
    params = dataclasses.replace(
        params_from_flat(run["flat"], tc, "cpu"),
        lora=tlora.make_lora_stack(ads, tc, device="cpu"))
    got = [tllama.forward(params, torch.from_numpy(tok),
                          tllama.init_cache(tc, B, MAX_SEQ, "cpu"), tc,
                          adapter_ids=torch.from_numpy(ids),
                          device="cpu")[0].numpy()
           for ids in (IDS, base_ids)]
    one = IDS == 1
    assert np.array_equal(ref[0], ref[1])       # the reference's fault
    assert np.array_equal(got[0][~one], got[1][~one])
    moved = np.abs(got[0][one] - got[1][one]).max()
    assert moved > 1e-2 * np.abs(got[1][one]).max()


# ── engine ──────────────────────────────────────────────────────────────

N_NEW = 6
# the prompt of the prefix-cache fault (20 tokens: two full 8-token pages)
FAULT_PROMPT = [int(t) for t in np.random.default_rng(5).integers(
    3, JCFG.vocab_size, 20)]


def _loras():
    return {"a1": _adapter(JCFG, 76, r=4), "a2": _adapter(JCFG, 77, r=2)}


def _requests():
    """(prompt, adapter) pairs decoded together: the fault's prompt under
    the base and under a1, two more prompts under a1 and a2 (all of 17-32
    tokens: one prefill program of the JAX engine)."""
    rng = np.random.default_rng(8)
    p1, p2 = ([int(t) for t in rng.integers(3, JCFG.vocab_size, n)]
              for n in (18, 25))
    return [(FAULT_PROMPT, None), (p1, "a1"), (p2, "a2"),
            (FAULT_PROMPT, "a1")]


def _drive(eng, make_req, reqs):
    rs = [make_req(req_id=i, prompt=list(p), max_new_tokens=N_NEW, lora=a)
          for i, (p, a) in enumerate(reqs)]
    for r in rs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in rs]


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine (contiguous, no prefix cache) over the co-batched
    requests, driven by ``step()``; its flat params and streams."""
    jp = jllama.init_params(JCFG, seed=75)
    eng = JEngine(jp, JCFG, max_slots=4, max_seq=64, eos_id=-1,
                  loras=_loras())
    streams = _drive(eng, JRequest, _requests())
    return {"engine": eng, "flat": _flat(jp), "streams": streams}


@pytest.fixture(scope="module")
def tparams(jax_engine):
    return params_from_flat(jax_engine["flat"], _tcfg(JCFG), "cpu")


@pytest.mark.parametrize("kind", ["contiguous", "paged-prefix"])
def test_engine_matches_jax(jax_engine, tparams, kind):
    """The base and two adapters decode together, token-identical to the
    JAX engine; with a prefix cache the fault's prompt under a1, admitted
    after the base request with the same prompt, must not reuse the base's
    pages."""
    kw = ({"paged": True, "page_size": 8, "prefix_cache": True}
          if kind == "paged-prefix" else {})
    eng = TEngine(tparams, _tcfg(JCFG), max_slots=4, max_seq=64, eos_id=-1,
                  loras=_loras(), device="cpu", **kw)
    got = _drive(eng, TRequest, _requests())
    assert got == jax_engine["streams"]
    assert all(len(o) == N_NEW for o in got)
    assert got[0] != got[3]       # the adapter moves the stream
    assert eng.stats["loras"] == 2
    assert eng.lora_names == {None: 0, "a1": 1, "a2": 2}
    if kw:
        assert eng.stats["prefix_hit_tokens"] == 0
    with pytest.raises(ValueError, match="unknown lora adapter 'a3'"):
        eng.add_request(TRequest(req_id=9, prompt=[3], max_new_tokens=1,
                                 lora="a3"))


def test_prefix_cache_keys_name_the_adapter(jax_engine, tparams):
    """The reference's fault: one slot, pages of 8, a prefix cache; the
    prompt under a1, then under the base. The JAX engine's keys hash only
    the tokens, so its base request reuses a1's two pages (16 hit tokens)
    and decodes from a1's KV. The port's base stream is the engine's without
    a prefix cache; a second a1 request still hits a1's pages."""
    eng = TEngine(tparams, _tcfg(JCFG), max_slots=1, max_seq=64, eos_id=-1,
                  paged=True, page_size=8, prefix_cache=True,
                  loras={"a1": _loras()["a1"]}, device="cpu")
    reqs = [(FAULT_PROMPT, "a1"), (FAULT_PROMPT, None)]
    got = []
    for i, req in enumerate(reqs):
        got += _drive(eng, lambda **kw: TRequest(**dict(kw, req_id=i)),
                      [req])
    streams = jax_engine["streams"]
    assert got == [streams[3], streams[0]]
    assert eng.stats["prefix_hit_tokens"] == 0
    again = _drive(eng, TRequest, [(FAULT_PROMPT, "a1")])
    assert again == [streams[3]]
    assert eng.stats["prefix_hit_tokens"] == 16


def test_loadgen_runs_under_an_adapter(tparams):
    """``LoadSpec(lora=)`` puts every request under that adapter, with the
    arrivals of the same spec without it (``test_torch_serving_api.py``
    holds those to JAX's), and the run serves them."""
    from quant_tpu_torch.engine import loadgen

    spec = dict(n_requests=3, rate=1e4, prompt_len=(4, 8), max_new=(2, 3),
                seed=1)
    plain, under = (loadgen._arrivals(loadgen.LoadSpec(**spec, lora=a),
                                      JCFG.vocab_size) for a in (None, "a1"))
    assert [(t, r.prompt, r.max_new_tokens) for t, r in under] == [
        (t, r.prompt, r.max_new_tokens) for t, r in plain]
    assert {r.lora for _, r in under} == {"a1"}
    eng = TEngine(tparams, _tcfg(JCFG), max_slots=2, max_seq=64, eos_id=-1,
                  loras=_loras(), device="cpu")
    rep = loadgen.run_load(eng, loadgen.LoadSpec(**spec, lora="a1", block=2))
    assert rep["requests"] == 3 and rep["output_tokens"] >= 6


# ── loader, server, CLI ─────────────────────────────────────────────────


def _peft_dir(path, ad, r):
    """A PEFT adapter directory of a ``make_lora_stack`` dict (lora_A
    stored [r, K], lora_B [N, r]), as ``peft`` saves it."""
    from safetensors.numpy import save_file

    mods = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj", "wkv_a": "self_attn.kv_a_proj_with_mqa"}
    tensors = {}
    for key, v in ad.items():
        if key == "alpha":
            continue
        _, li, proj, kind = key.split(".")
        name = f"base_model.model.model.layers.{li}.{mods[proj]}.lora_"
        tensors[name + ("A" if kind == "a" else "B") + ".weight"] = (
            np.ascontiguousarray(v.T))
    path.mkdir()
    save_file(tensors, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps(
        {"lora_alpha": ad["alpha"], "r": r, "peft_type": "LORA"}))
    return path


def test_load_hf_adapter_matches_jax(tmp_path):
    cfg = JPRESETS["test-tiny-mla"]
    src = _loras()["a1"]
    src.update({k: v for k, v in _mla_adapter(cfg, 9, projs=(
        "wkv_a",)).items() if k != "alpha"})
    path = _peft_dir(tmp_path / "a1", src, 4)
    ref, got = jlora.load_hf_adapter(path), tlora.load_hf_adapter(path)
    assert sorted(got) == sorted(ref) == sorted(src)
    for k, v in ref.items():
        assert np.array_equal(got[k], v) and np.array_equal(got[k], src[k])


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


def _ask(base, path, payload=None):
    """(status, body); an SSE answer's token ids concatenated."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with _OPEN(req, timeout=120) as r:
            raw = r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if payload and payload.get("stream"):
        events = [json.loads(ln[6:]) for ln in raw.decode().splitlines()
                  if ln.startswith("data: {")]
        return 200, sum((e["choices"][0]["token_ids"] for e in events), [])
    return 200, json.loads(raw)


def test_server_routes_adapters_like_jax(jax_engine, tparams):
    """The same requests to the port's server and to the JAX server over
    the JAX engine run: ``lora`` on /generate, ``model`` naming an adapter
    on /v1/completions (streamed too) and /v1/chat/completions, the served
    name routing to the base; an unknown ``lora`` answers 400 on both and
    ``/v1/models`` lists the same adapters."""
    from quant_tpu.engine.server import serve_async as jserve
    from quant_tpu_torch.engine.server import serve_async as tserve

    (pf, _), (p1, _), (p2, _), _ = _requests()
    payloads = [
        ("/generate", {"prompt_ids": p1, "max_new_tokens": N_NEW,
                       "lora": "a1"}),
        ("/generate", {"prompt_ids": pf, "max_new_tokens": N_NEW,
                       "model": "tiny"}),
        ("/v1/completions", {"prompt": p2, "max_tokens": N_NEW,
                             "temperature": 0.0, "model": "a2"}),
        ("/v1/completions", {"prompt": pf, "max_tokens": N_NEW,
                             "temperature": 0.0, "lora": "a1",
                             "stream": True}),
        ("/v1/chat/completions", {"messages": [
            {"role": "user", "content": "hi there, how are you"}],
            "max_tokens": N_NEW, "temperature": 0.0, "model": "a2"}),
        ("/generate", {"prompt_ids": p1, "max_new_tokens": 2,
                       "lora": "a3"}),
    ]
    answers = []
    teng = TEngine(tparams, _tcfg(JCFG), max_slots=4, max_seq=64, eos_id=-1,
                   loras=_loras(), device="cpu")
    for serve, eng in ((jserve, jax_engine["engine"]), (tserve, teng)):
        httpd, srv = serve(eng, tokenizer=_StubTokenizer(),
                           model_name="tiny")
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            answers.append([_ask(base, p, b) for p, b in payloads]
                           + [_ask(base, "/v1/models")])
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.stop()
    ref, got = answers
    streams = jax_engine["streams"]
    assert got[0][1]["output_ids"] == ref[0][1]["output_ids"] == streams[1]
    assert got[1][1]["output_ids"] == ref[1][1]["output_ids"] == streams[0]
    for i in (2, 4):
        assert (got[i][1]["choices"][0]["token_ids"]
                == ref[i][1]["choices"][0]["token_ids"]), i
    assert got[2][1]["choices"][0]["token_ids"] == streams[2]
    assert got[3] == ref[3] == (200, streams[3])
    assert got[5][0] == ref[5][0] == 400
    assert "unknown lora adapter 'a3'" in got[5][1]["error"]
    assert got[6] == ref[6]
    assert [m.get("parent") for m in got[6][1]["data"]] == [None, "tiny",
                                                              "tiny"]


def test_cli_generate_with_lora_prints_jax_lines(tmp_path, tparams,
                                                 jax_engine, capsys):
    from quant_tpu_torch.checkpoint import save_checkpoint
    from quant_tpu_torch.cli import main as tmain

    save_checkpoint(str(tmp_path / "ckpt"), tparams, _tcfg(JCFG))
    peft = _peft_dir(tmp_path / "a1", _loras()["a1"], 4)
    (pf, _), (p1, _), _, _ = _requests()
    argv = ["generate", str(tmp_path / "ckpt"), "--prompt-ids",
            ";".join(",".join(map(str, p)) for p in (p1, pf)),
            "--max-new", str(N_NEW), "--slots", "2", "--max-seq", "64",
            "--eos-id", "-1", "--lora", f"a1={peft}", "--use-lora", "a1",
            "--device", "cpu"]
    assert tmain(argv) == 0
    out, err = capsys.readouterr()
    streams = jax_engine["streams"]
    assert out.splitlines() == [json.dumps({"prompt": p, "output": o})
                                for p, o in ((p1, streams[1]),
                                             (pf, streams[3]))]
    assert json.loads(err.splitlines()[-1])["stats"]["loras"] == 1
    with pytest.raises(SystemExit, match="name=/path/to/adapter"):
        tmain(argv[:-6] + ["--lora", "a1", "--device", "cpu"])
