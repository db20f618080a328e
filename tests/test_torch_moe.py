"""The port's sparse-MoE path against the JAX package (CPU).

Every JAX result comes from one module-scoped run per kind (``jax_*``
fixtures), on the same numpy inputs as the port:

* ``moe_route`` against ``llama.moe_route`` in float32: Mixtral's softmax
  with ``norm_topk``, no renormalization, sigmoid scores with a selection
  bias and top-2-sum group-limited routing, and max-score groups. Weights
  within 1e-6.
* ``dequant_matmul_moe`` (its plain version on the CPU) against the JAX
  kernel run with ``interpret=True``: concat and psum, int4 and int8, with
  and without a hot list (n_hot < E). Within 1e-5 of max|ref|. The JAX tail
  slots (at or past n_hot) hold clamped garbage by design, so only the hot
  slots are compared; the port's tail must be exactly 0 in concat, and in
  psum its tail slots' x rows are NaN (the JAX side gets zeros there) and
  must not reach the result.
* ``_pad_moe_down_k`` / ``_pad_x_to_k`` byte-equal to the JAX helpers.
* ``forward`` logits and cache against ``llama.forward(kernel_mode="xla")``
  for a prefill then three decode steps, in the port's plain mode ("xla")
  and its kernel mode ("auto"): ``test-tiny-moe`` in float32 and bfloat16,
  and a tiny Qwen3-MoE-like config (``qk_norm``, 8 experts, a down
  projection whose K pads from 384 to 1024) in float32. Tolerances of
  ``tests/test_torch_llama.py``: float32 logits within 1e-4 * max|logit|
  (1e-3 after a KV code that differs by one step), bfloat16 within 3e-2.
* Routed (hot-list) against dense all-experts dispatch at B = 1..4, within
  1e-5 * max|logit| in float32.
* Greedy ``Engine`` streams token-identical to the JAX ``Engine`` on
  ``test-tiny-moe``, contiguous and paged.
* ``test-tiny-moe`` checkpoints round-trip both ways, byte-equal.

Routing near-ties: ``torch.topk`` and ``jax.lax.top_k`` may keep different
experts when the k-th and (k+1)-th scores lie within rounding of each other.
The tests record every routing decision of the port and assert the margin
between those two router logits: at least 1e-5 in float32; in bfloat16,
where the two frameworks round the hidden state at other places, at least
0.1 (seed 7 is used for that run: its smallest margin measured 0.17).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.checkpoint.format import load_checkpoint as j_load
from quant_tpu.checkpoint.format import save_checkpoint as j_save
from quant_tpu.core.qtensor import quantize_tensor as j_quantize
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.dequant_matmul import dequant_matmul_moe as j_moe
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu.models.config import ModelConfig as JConfig
from quant_tpu_torch.checkpoint.format import load_checkpoint as t_load
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.kernels.dequant_matmul import (
    dequant_matmul_moe, dequant_matmul_moe_reference)
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import flat_from_params, params_from_flat

JTINY = dataclasses.replace(JPRESETS["test-tiny-moe"], dtype="float32")
TTINY = TConfig(**dataclasses.asdict(JTINY))
# Qwen3-30B-A3B's MoE traits at test size: QK-RMSNorm, 8 experts top-2, a
# per-expert intermediate (384) whose down projection pads to 1024
_QWEN = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=64, intermediate=384, group_size=64, n_experts=8,
             experts_per_token=2, qk_norm=True, norm_eps=1e-6,
             rope_theta=1e6, kernel_mode="xla")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(jparams):
    return jax.tree.map(np.asarray, _flatten_params(jparams))


def _margin(logits: torch.Tensor, k: int) -> float:
    s = logits.sort(dim=-1, descending=True).values
    return float((s[..., k - 1] - s[..., k]).min())


@pytest.fixture
def routing_margins(monkeypatch):
    """Record the smallest top-k margin of the router logits over every
    ``moe_route`` call the port makes."""
    seen = []
    inner = tllama.moe_route

    def route(x, router, cfg, bias=None):
        seen.append(_margin(x.float() @ router.float(), cfg.experts_per_token))
        return inner(x, router, cfg, bias)
    monkeypatch.setattr(tllama, "moe_route", route)
    return seen


# ── routing ─────────────────────────────────────────────────────────────

_ROUTES = {
    "mixtral": dict(n_experts=8, experts_per_token=2),
    "no-renorm": dict(n_experts=16, experts_per_token=6, norm_topk=False),
    "sigmoid-bias-top2sum": dict(
        n_experts=16, experts_per_token=4, score_fn="sigmoid",
        router_bias=True, n_expert_groups=4, topk_groups=2,
        group_score="top2sum", routed_scaling=2.5),
    "groups-max": dict(n_experts=16, experts_per_token=3, n_expert_groups=4,
                       topk_groups=2, norm_topk=False),
}


def _route_inputs(name):
    rng = np.random.default_rng(len(name))
    e = _ROUTES[name]["n_experts"]
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    router = rng.standard_normal((64, e), dtype=np.float32) * 0.1
    bias = rng.standard_normal(e).astype(np.float32) * 0.05
    return x, router, bias


@pytest.fixture(scope="module")
def jax_routes():
    out = {}
    for name, kw in _ROUTES.items():
        x, router, bias = _route_inputs(name)
        cfg = dataclasses.replace(JPRESETS["test-tiny"], **kw)
        out[name] = np.asarray(jllama.moe_route(
            jnp.asarray(x), jnp.asarray(router), cfg,
            bias=jnp.asarray(bias) if cfg.router_bias else None))
    return out


def _selection_margins(x, router, bias, cfg):
    """(expert margin, group margin) of the selection scores, in float64:
    the gap between the k-th and (k+1)-th score (and group score)."""
    logits = (x.astype(np.float64) @ router.astype(np.float64)).reshape(
        -1, cfg.n_experts)
    if cfg.score_fn == "sigmoid":
        probs = 1 / (1 + np.exp(-logits))
    else:
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
    sel = probs + bias if cfg.router_bias else probs
    g_margin = np.inf
    if cfg.n_expert_groups:
        gsel = sel.reshape(len(sel), cfg.n_expert_groups, -1)
        srt = -np.sort(-gsel, axis=-1)
        gscore = (srt[..., :2].sum(-1) if cfg.group_score == "top2sum"
                  else srt[..., 0])
        order = np.argsort(-gscore, axis=-1)
        gs = np.take_along_axis(gscore, order, -1)
        g = cfg.topk_groups
        g_margin = (gs[:, g - 1] - gs[:, g]).min()
        keep = np.zeros(gscore.shape, bool)
        np.put_along_axis(keep, order[:, :g], True, -1)
        sel = np.where(keep[..., None], gsel, 0.0).reshape(len(sel), -1)
    s = -np.sort(-sel, axis=-1)
    k = cfg.experts_per_token
    return (s[:, k - 1] - s[:, k]).min(), g_margin


@pytest.mark.parametrize("name", list(_ROUTES))
def test_moe_route_matches_jax(jax_routes, name):
    x, router, bias = _route_inputs(name)
    cfg = dataclasses.replace(TConfig(**dataclasses.asdict(
        JPRESETS["test-tiny"])), **_ROUTES[name])
    got = tllama.moe_route(torch.from_numpy(x), torch.from_numpy(router),
                           cfg, torch.from_numpy(bias)
                           if cfg.router_bias else None).numpy()
    ref = jax_routes[name]
    assert got.shape == ref.shape == (3, 5, cfg.n_experts)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert ((got > 0).sum(-1) == cfg.experts_per_token).all()
    e_margin, g_margin = _selection_margins(x, router, bias, cfg)
    assert e_margin >= 1e-5 and g_margin >= 1e-5, (e_margin, g_margin)


# ── the kernel's plain version ──────────────────────────────────────────

E, NL, K, N, M = 4, 2, 256, 256, 3
HOT = [2, 3, 1, 1, 1]          # experts 3 and 1 hot, the tail repeats 1
_MOE_CASES = [("concat", 4, True), ("concat", 8, False), ("psum", 4, False),
              ("psum", 8, True)]


def _moe_inputs(mode, bits, use_hot):
    rng = np.random.default_rng(bits * 10 + len(mode) + use_hot)
    g = 64 if bits == 4 else 128
    qs = [j_quantize(rng.standard_normal((K, N), dtype=np.float32), bits,
                     group_size=g) for _ in range(E * NL)]
    jq = jax.tree.map(lambda *a: np.stack(a), *qs)       # [E*L, ...]
    shape = (M, K) if mode == "concat" else (E, M, K)
    x = rng.standard_normal(shape, dtype=np.float32)
    return jq, x


@pytest.fixture(scope="module")
def jax_moe():
    out = {}
    for mode, bits, use_hot in _MOE_CASES:
        jq, x = _moe_inputs(mode, bits, use_hot)
        if use_hot and mode != "concat":
            x = x.copy()
            x[HOT[0]:] = 0.0        # the JAX caller zeroes the tail's rows
        out[mode, bits, use_hot] = np.asarray(j_moe(
            jnp.asarray(x), jq, jnp.int32(1), n_experts=E, stride=NL,
            mode=mode, interpret=True, out_dtype=jnp.float32,
            hot=jnp.asarray(HOT, jnp.int32) if use_hot else None))
    return out


@pytest.mark.parametrize("mode,bits,use_hot", _MOE_CASES)
def test_dequant_matmul_moe_matches_jax(jax_moe, mode, bits, use_hot):
    jq, x = _moe_inputs(mode, bits, use_hot)
    tq = QTensor(codes=torch.from_numpy(np.asarray(jq.codes)),
                 scales=torch.from_numpy(np.asarray(jq.scales)), bits=bits,
                 group_size=jq.group_size, shape=(K, N))
    hot = torch.tensor(HOT, dtype=torch.int32) if use_hot else None
    n_hot = HOT[0] if use_hot else E
    if use_hot and mode != "concat":
        x = x.copy()
        x[n_hot:] = np.nan         # tail slots must not be read
    kw = dict(n_experts=E, stride=NL, mode=mode, hot=hot)
    got = dequant_matmul_moe(torch.from_numpy(x), tq, 1, **kw)
    # the CPU dispatch is the plain version
    assert torch.equal(got, dequant_matmul_moe_reference(
        torch.from_numpy(x), tq, 1, **kw))
    ref = jax_moe[mode, bits, use_hot]
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    if mode == "concat":
        got, ref = got.reshape(M, E, N), ref.reshape(M, E, N)
        assert not got[:, n_hot:].any()        # exact zeros past n_hot
        got, ref = got[:, :n_hot], ref[:, :n_hot]
    err = np.max(np.abs(got - ref))
    assert err <= 1e-5 * np.max(np.abs(ref)), err


def test_moe_grouped_mode_is_not_ported():
    tq = QTensor(codes=torch.zeros((2, 8, 8), dtype=torch.uint8),
                 scales=torch.ones((2, 1, 8)), bits=4, group_size=16,
                 shape=(16, 8))
    with pytest.raises(NotImplementedError, match="grouped"):
        dequant_matmul_moe(torch.zeros((2, 1, 16)), tq, 0, n_experts=2,
                           stride=1, mode="grouped")


@pytest.mark.parametrize("k", [768, 1024])
def test_pad_moe_down_k_matches_jax(k):
    """Qwen3-30B-A3B's 768 pads to 1024; a 1024 multiple stays as it is."""
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, 32), dtype=np.float32)
    ref = np.asarray(jllama._pad_moe_down_k(w, 1))
    assert ref.shape[0] == 1024
    got_np = tllama._pad_moe_down_k(w)
    got_t = tllama._pad_moe_down_k(torch.from_numpy(w)).numpy()
    assert got_np.tobytes() == ref.tobytes() == got_t.tobytes()
    a = rng.standard_normal((2, 3, k), dtype=np.float32)
    xref = np.asarray(jllama._pad_x_to_k(jnp.asarray(a), ref.shape[0], 1))
    xgot = tllama._pad_x_to_k(torch.from_numpy(a), ref.shape[0]).numpy()
    assert xgot.tobytes() == xref.tobytes()


# ── forward ─────────────────────────────────────────────────────────────

_FWD = {"test-tiny-moe-float32": ("float32", 3),
        "test-tiny-moe-bfloat16": ("bfloat16", 7),
        "qwen3-moe-tiny-float32": ("float32", 3)}


def _fwd_configs(name):
    dtype, seed = _FWD[name]
    if name.startswith("test-tiny-moe"):
        jc = dataclasses.replace(JPRESETS["test-tiny-moe"], dtype=dtype)
    else:
        jc = JConfig(**_QWEN, dtype=dtype)
    return jc, TConfig(**dataclasses.asdict(jc)), seed


def _fwd_inputs(vocab):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, vocab, (2, 12)).astype(np.int32)
    steps = [rng.integers(0, vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]
    return prompt, steps


# one trace for the prefill and one for the decode steps (eager, each step
# took as long as a trace)
_jit_forward = jax.jit(jllama.forward, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def jax_forward():
    """name -> (JAX params flattened, logits per call, final cache)."""
    out = {}
    for name in _FWD:
        jc, _, seed = _fwd_configs(name)
        jp = jllama.init_params(jc, seed=seed)
        prompt, steps = _fwd_inputs(jc.vocab_size)
        cache = jllama.init_cache(jc, 2, 64)
        outs = []
        for tok in [prompt] + steps:
            lg, cache = _jit_forward(jp, jnp.asarray(tok), cache, cfg=jc)
            outs.append(np.asarray(lg, np.float32))
        out[name] = (_flat(jp), outs, jax.tree.map(np.asarray, cache))
    return out


def _port_run(tparams, tc, tokens, b, max_seq=64):
    cache = tllama.init_cache(tc, b, max_seq, "cpu")
    outs = []
    for tok in tokens:
        lg, cache = tllama.forward(tparams, torch.from_numpy(tok), cache, tc,
                                   device="cpu")
        outs.append(lg.float().numpy())
    return outs, cache


@pytest.mark.parametrize("name", list(_FWD))
def test_moe_forward_matches_jax(jax_forward, routing_margins, name):
    jc, tc, _ = _fwd_configs(name)
    flat, ref, jcache = jax_forward[name]
    tparams = params_from_flat(flat, tc, "cpu")
    assert tparams.layers.w_gate_up is None
    assert tuple(tparams.layers.we_down.codes.shape[:2]) == (
        jc.n_experts, jc.n_layers)
    prompt, steps = _fwd_inputs(jc.vocab_size)
    for mode in ("xla", "auto"):
        tcm = dataclasses.replace(tc, kernel_mode=mode)
        got, tcache = _port_run(tparams, tcm, [prompt] + steps, 2)
        f32 = jc.dtype == "float32"
        if f32:
            diff = np.zeros((2, 64), bool)
            for jcodes, tcodes in ((jcache.k_codes, tcache.k_codes),
                                   (jcache.v_codes, tcache.v_codes)):
                diff |= (jcodes != tcodes.numpy()).any(axis=(0, 2, 4))
            tainted = np.cumsum(diff, axis=1) > 0
        pos0 = 0
        for r, g in zip(ref, got):
            assert r.shape == g.shape
            err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
            tol = (np.where(tainted[:, pos0:pos0 + r.shape[1]], 1e-3, 1e-4)
                   if f32 else 3e-2)
            assert np.all(err <= tol), (mode, err)
            pos0 += r.shape[1]
        if f32:
            for jc_codes, tc_codes in ((jcache.k_codes, tcache.k_codes),
                                       (jcache.v_codes, tcache.v_codes)):
                d = np.abs(jc_codes.astype(np.int32)
                           - tc_codes.numpy().astype(np.int32))
                assert d.max() <= 1 and np.mean(d > 0) <= 1e-3
            for js, ts in ((jcache.k_scale, tcache.k_scale),
                           (jcache.v_scale, tcache.v_scale)):
                np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0)
    assert min(routing_margins) >= (1e-5 if jc.dtype == "float32" else 0.1)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_routed_matches_dense_dispatch(jax_forward, routing_margins,
                                       monkeypatch, b):
    """The hot-list path (every decode step here: E=8, top-2, B <= 4)
    against all-experts slots, both through the kernels' dispatch."""
    jc, tc, _ = _fwd_configs("qwen3-moe-tiny-float32")
    tparams = params_from_flat(jax_forward["qwen3-moe-tiny-float32"][0], tc,
                               "cpu")
    hot_calls = []
    inner = tllama.dequant_matmul_moe

    def spy(x, qt, layer, **kw):
        if kw.get("hot") is not None:
            hot_calls.append(int(kw["hot"][0]))
        return inner(x, qt, layer, **kw)
    monkeypatch.setattr(tllama, "dequant_matmul_moe", spy)
    rng = np.random.default_rng(b)
    tokens = [rng.integers(0, jc.vocab_size, (b, 6)).astype(np.int32)] + [
        rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32)
        for _ in range(3)]
    runs = {}
    for routed in ("on", "off"):
        hot_calls.clear()
        c = dataclasses.replace(tc, kernel_mode="auto", moe_routed=routed)
        runs[routed], _ = _port_run(tparams, c, tokens, b)
        # 2 launches per layer and decode step, each with fewer hot slots
        # than experts
        if routed == "on":
            assert len(hot_calls) == 2 * jc.n_layers * 3
            assert max(hot_calls) < jc.n_experts
        else:
            assert not hot_calls
    for r, d in zip(runs["on"], runs["off"]):
        assert np.max(np.abs(r - d)) <= 1e-5 * np.max(np.abs(d))
    assert min(routing_margins) >= 1e-5


# ── engine and checkpoint ───────────────────────────────────────────────


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(3, JTINY.vocab_size, n)]
            for n in (5, 11, 3)]


def _drive(eng, make_req):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


_ENGINES = {"contiguous": dict(max_slots=2, max_seq=64, eos_id=-1),
            "paged": dict(max_slots=2, max_seq=64, eos_id=-1, paged=True,
                          page_size=8)}


@pytest.fixture(scope="module")
def jax_engine():
    jp = jllama.init_params(JTINY, seed=0)
    return jp, {k: _drive(JEngine(jp, JTINY, **kw), JRequest)
                for k, kw in _ENGINES.items()}


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_moe_engine_matches_jax(jax_engine, kind):
    jp, streams = jax_engine
    tc = dataclasses.replace(TTINY, kernel_mode="auto")
    eng = TEngine(params_from_flat(_flat(jp), tc, "cpu"), tc, device="cpu",
                  **_ENGINES[kind])
    got = _drive(eng, TRequest)
    assert got == streams[kind]
    assert all(len(o) == 6 for o in got)


def _leaves(flat):
    return {name: [np.asarray(p) if not isinstance(p, torch.Tensor)
                   else p.numpy() for p in ([leaf.codes, leaf.scales]
                                            if hasattr(leaf, "codes")
                                            else [leaf])]
            for name, leaf in flat.items()}


def test_moe_checkpoint_round_trips_both_ways(tmp_path, jax_engine):
    jp, _ = jax_engine
    jflat = _leaves(_flat(jp))
    assert "layers.1.we_down.3" in jflat and "layers.0.w_gate_up" not in jflat
    j_save(tmp_path / "j", jp, JTINY)
    tparams, cfg = t_load(tmp_path / "j", device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JTINY)
    tflat = _leaves(flat_from_params(tparams))
    assert tflat.keys() == jflat.keys()
    for name in jflat:
        for a, b in zip(tflat[name], jflat[name]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    t_save(tmp_path / "t", tparams, cfg)
    jloaded, jcfg = j_load(tmp_path / "t", device=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(JTINY)
    back = _leaves(_flat(jloaded))
    assert back.keys() == jflat.keys()
    for name in jflat:
        for a, b in zip(back[name], jflat[name]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("change", [
    {"act_quant": True}, {"embed_bits": 4},
    {"moe_prefill": "capacity"}, {"codebook": "nf4"},
    {"moe_fused": False}])
def test_moe_outside_the_slice_raises(change):
    """Shared experts, dense-prefix layers and the selection bias are
    ported (``tests/test_torch_mla.py``), and so are the unquantized and
    the int4 caches; the capacity dispatch, the per-expert loop, W8A8,
    codebooks and 4-bit embeddings are not."""
    cfg = dataclasses.replace(TTINY, **change)
    with pytest.raises(NotImplementedError):
        tllama.init_params(cfg, seed=0, device="cpu")


def test_moe_init_params_structure():
    """The port's own random MoE weights: expert-major stacks made in place,
    the down projection padded to 1024 rows, qk_norm gains drawn."""
    tc = TConfig(**_QWEN)
    p = tllama.init_params(tc, seed=0, device="cpu")
    lay = p.layers
    assert lay.w_gate_up is None and lay.w_down is None
    assert tuple(lay.we_gate_up.codes.shape) == (8, 2, 128, 768)
    assert tuple(lay.we_down.codes.shape) == (8, 2, 512, 256)
    assert tuple(lay.router.shape) == (2, 256, 8)
    assert not torch.equal(lay.q_norm, torch.ones_like(lay.q_norm))
    down = tllama._merge_experts(lay.we_down).layer(5)
    assert not down.dequantize()[384:].any()       # padded rows are zero
    cache = tllama.init_cache(tc, 1, 16, "cpu")
    lg, _ = tllama.forward(p, [[1, 2, 3]], cache,
                           dataclasses.replace(tc, kernel_mode="auto"),
                           device="cpu")
    assert torch.isfinite(lg).all()
