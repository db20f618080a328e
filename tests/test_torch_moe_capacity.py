"""The port's MoE capacity dispatch, int8-activation expert stacks and the
per-expert loop against the JAX package (CPU, float32).

Every JAX result comes from one module-scoped run per kind, on the same
numpy inputs as the port:

* ``dequant_matmul_moe``'s plain version (the CPU path of the wrapper)
  against the JAX kernel run with ``interpret=True``: ``grouped`` at int4
  and int8, with and without a hot list, and ``act_quant`` in ``concat``,
  ``psum`` and ``grouped`` (with and without a hot list). Within 1e-5 of
  max|ref| (the tolerance of ``test_dequant_matmul_moe_matches_jax``); an
  aq row whose x holds a value within 1e-4 of an int8 rounding tie (either
  package may round it either way) within 1e-2, the rule of
  ``tests/test_torch_quant.py``. The JAX tail slots (at or past n_hot)
  hold clamped garbage by design, so only the hot slots are compared; the
  port's grouped tail must be exactly 0, and its tail slots' x rows are NaN
  (the JAX side gets zeros there) and must not reach the result.
* ``forward`` logits (a B=8, T=8 prefill, where 64 tokens x top-2 >= 2E
  engages the capacity dispatch, then three B=8 decode steps, where 8 x 2
  >= 2E engages it too) against JAX ``forward(kernel_mode="xla")`` on
  ``test-tiny-moe``: capacity at cf 4 (nothing drops) and cf 0.3 (tokens
  drop at the prefill; the dropped (token, expert) pairs must be the same
  as JAX's, read from its routing weights), W4A8 (``act_quant``) through
  the fused dispatch and through ``moe_fused=False``; and
  ``test-tiny-dsv3`` (shared experts, a dense-prefix layer, sigmoid
  group-limited routing) under capacity at cf 4. Each in the port's kernel
  mode ("auto", the kernels' plain versions on the CPU) and the capacity
  variants also in its plain mode ("xla"). Logits within 1e-4
  of max|logit|; within 1e-2 in a slot from its first K code that differs
  by one step (a rounding tie of ``quantize_kv``; codes differ by at most
  one step in at most 1e-2 of entries; on these inputs one code of layer 0
  differs, the slot's later layer-1 codes follow it (0.19% of entries) and
  its logits stand 2.7e-3 apart, beyond the 1e-3 that
  ``tests/test_torch_llama.py`` allows its own inputs), and from a forward
  call on where an activation code differs between the packages (a
  rounding tie of the int8 grid; each package's x read at every act_quant
  matmul). The fused W4A8 dispatch folds the routing weights into the down
  projection's x, where JAX's xla loop scales the output: its activation
  codes are held to the port's loop, which is held to JAX's.
* ``moe_fused=False`` (the per-expert loop through ``dequant_matmul``)
  against the fused dispatch, in the port: within 1e-5 of max|logit|; and
  ``test-tiny-dsv3`` at W4A8 under capacity, the grouped dispatch against
  the port's per-expert loop, within 1e-5. (Against JAX, W4A8 on
  ``test-tiny-dsv3`` met one activation code at a rounding tie in its
  prefill, in layer 1's ``wo`` input, and that token's logits stood
  1.6e-2 apart: one step of one code, amplified through two layers of
  routed experts at ``routed_scaling`` 2.5, beyond the 1e-2 rule; its
  capacity dispatch without W4A8 agrees within 2.7e-6.)
* A greedy ``Engine`` (4 slots, so decode at B=4 engages capacity too) at
  cf 4 token-identical to the JAX ``Engine``, contiguous and paged.
* ``generate --moe-prefill capacity --moe-routed off`` parses and runs.

Routing near-ties: every routing decision of the port is recorded and the
selection margin asserted (at least 1e-5): between the k-th and (k+1)-th
router logit for softmax routing, as in ``tests/test_torch_moe.py``, and
between selection scores and group scores for sigmoid routing with a bias,
as in ``tests/test_torch_mla.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.core.qtensor import quantize_tensor as j_quantize
from quant_tpu.engine import Engine as JEngine
from quant_tpu.engine import Request as JRequest
from quant_tpu.kernels.dequant_matmul import dequant_matmul_moe as j_moe
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.checkpoint.format import save_checkpoint as t_save
from quant_tpu_torch.cli import main as t_cli
from quant_tpu_torch.core.qtensor import QTensor
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine import Request as TRequest
from quant_tpu_torch.kernels import dequant_matmul as dmm_mod
from quant_tpu_torch.kernels.dequant_matmul import (
    dequant_matmul_moe, dequant_matmul_moe_reference)
from quant_tpu_torch.models import llama as tllama
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat


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


def _near_tie(x: np.ndarray, g: int) -> np.ndarray:
    """Rows of x [R, K] holding a value within 1e-4 of a rounding tie of
    its per-(row, group) int8 grid (scale absmax / 127)."""
    xg = x.reshape(x.shape[0], -1, g).astype(np.float64)
    sx = np.abs(xg).max(-1, keepdims=True) / 127.0
    u = np.abs(xg) / np.where(sx == 0, 1.0, sx)
    return (np.abs(u - np.floor(u) - 0.5) < 1e-4).any(axis=(1, 2))


def _codes(x: np.ndarray, g: int) -> np.ndarray:
    """The int8 grid both packages put activations on (per row and group:
    scale absmax / 127, round half to even), in numpy."""
    xg = x.reshape(x.shape[0], -1, g).astype(np.float32)
    sx = np.max(np.abs(xg), axis=-1, keepdims=True) / np.float32(127.0)
    sx = np.where(sx == 0, np.float32(1.0), sx)
    return np.round(xg / sx).reshape(x.shape)


# ── the kernel's plain version against the Pallas kernel ────────────────

E, NL, K, N, M = 4, 2, 256, 256, 5
HOT = [2, 3, 1, 1, 1]          # experts 3 and 1 hot, the tail repeats 1
# (mode, bits, hot list, act_quant)
_CASES = [("grouped", 4, False, False), ("grouped", 8, False, False),
          ("grouped", 4, True, False), ("grouped", 8, True, False),
          ("concat", 4, False, True), ("psum", 4, False, True),
          ("psum", 8, True, True), ("grouped", 4, False, True),
          ("grouped", 8, True, True)]


def _inputs(mode, bits, use_hot, aq):
    rng = np.random.default_rng(bits * 10 + len(mode) + 2 * use_hot + 4 * aq)
    g = 64 if bits == 4 else 128
    qs = [j_quantize(rng.standard_normal((K, N), dtype=np.float32), bits,
                     group_size=g) for _ in range(E * NL)]
    jq = jax.tree.map(lambda *a: np.stack(a), *qs)       # [E*L, ...]
    shape = (M, K) if mode == "concat" else (E, M, K)
    return jq, rng.standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def jax_moe():
    out = {}
    for case in _CASES:
        mode, bits, use_hot, aq = case
        jq, x = _inputs(*case)
        if use_hot:
            x = x.copy()
            x[HOT[0]:] = 0.0        # the JAX caller zeroes the tail's rows
        out[case] = np.asarray(j_moe(
            jnp.asarray(x), jq, jnp.int32(1), n_experts=E, stride=NL,
            mode=mode, interpret=True, out_dtype=jnp.float32, act_quant=aq,
            hot=jnp.asarray(HOT, jnp.int32) if use_hot else None))
    return out


@pytest.mark.parametrize("mode,bits,use_hot,aq", _CASES)
def test_grouped_and_aq_moe_match_jax(jax_moe, mode, bits, use_hot, aq):
    jq, x = _inputs(mode, bits, use_hot, aq)
    tq = QTensor(codes=torch.from_numpy(np.asarray(jq.codes)),
                 scales=torch.from_numpy(np.asarray(jq.scales)), bits=bits,
                 group_size=jq.group_size, shape=(K, N))
    hot = torch.tensor(HOT, dtype=torch.int32) if use_hot else None
    n_hot = HOT[0] if use_hot else E
    if use_hot:
        x = x.copy()
        x[n_hot:] = np.nan         # tail slots must not be read
    kw = dict(n_experts=E, stride=NL, mode=mode, hot=hot, act_quant=aq)
    got = dequant_matmul_moe(torch.from_numpy(x), tq, 1, **kw)
    # the CPU dispatch is the plain version
    assert torch.equal(got, dequant_matmul_moe_reference(
        torch.from_numpy(x), tq, 1, **kw))
    ref = jax_moe[mode, bits, use_hot, aq]
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    # rows of the result and the x rows that feed each
    if mode == "concat":
        got, ref = got.reshape(M, E, N), ref.reshape(M, E, N)
        assert not got[:, n_hot:].any()
        got, ref = got[:, :n_hot], ref[:, :n_hot]
        ties = _near_tie(x, jq.group_size)[:, None]
    elif mode == "grouped":
        assert got.shape == (E, M, N) and not got[n_hot:].any()
        got, ref = got[:n_hot], ref[:n_hot]
        ties = _near_tie(x[:n_hot].reshape(-1, K), jq.group_size).reshape(
            n_hot, M)
    else:
        ties = _near_tie(x[:n_hot].reshape(-1, K), jq.group_size).reshape(
            n_hot, M).any(0)
    err = np.abs(got - ref).max(-1)
    tol = np.where(ties, 1e-2, 1e-5) if aq else 1e-5
    assert np.all(err <= tol * np.abs(ref).max()), (err.max(), ties.sum())


def test_kshards_and_codebook_stacks_refuse():
    """A tensor-parallel (kshards > 1) stack and a codebook stack raise,
    each naming itself; the codebook's message names the JAX reference's
    fault."""
    stack = QTensor(codes=torch.zeros((2, 64, 32), dtype=torch.uint8),
                    scales=torch.ones((2, 2, 32)), bits=4, group_size=64,
                    shape=(128, 32), kshards=2)
    x = torch.zeros((2, 128))
    with pytest.raises(NotImplementedError, match="kshards"):
        dequant_matmul_moe(x, stack, 0, n_experts=2, stride=1)
    lut = dataclasses.replace(stack, kshards=1, lut=torch.zeros((2, 16)))
    with pytest.raises(NotImplementedError, match="JAX reference fails"):
        dequant_matmul_moe(x, lut, 0, n_experts=2, stride=1, mode="grouped")


# ── forward ─────────────────────────────────────────────────────────────

B, T, STEPS, MAX_SEQ = 8, 8, 3, 16
# variant -> (preset, JAX config change, port kernel modes)
_VARIANTS = {
    "cap4": ("test-tiny-moe", {"moe_prefill": "capacity",
                               "moe_capacity_factor": 4.0}, ("auto", "xla")),
    "cap0.3": ("test-tiny-moe", {"moe_prefill": "capacity",
                                 "moe_capacity_factor": 0.3},
               ("auto", "xla")),
    "w4a8": ("test-tiny-moe", {"act_quant": True}, ("auto",)),
    "dsv3-cap4": ("test-tiny-dsv3", {"moe_prefill": "capacity",
                                     "moe_capacity_factor": 4.0},
                  ("auto", "xla")),
}


def _cfgs(variant, mode="xla", **kw):
    preset, change, _ = _VARIANTS[variant]
    jc = dataclasses.replace(JPRESETS[preset], dtype="float32",
                             kernel_mode="xla", attn_kernel="xla", **change)
    tc = TConfig(**dataclasses.asdict(jc))
    return jc, dataclasses.replace(tc, kernel_mode=mode, **kw)


def _tokens(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (B, T)).astype(np.int32)] + [
        rng.integers(0, vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]


def _kept_pairs(w: np.ndarray, cap: int) -> set:
    """(token, expert) pairs the capacity dispatch keeps from routing
    weights [N, E]: the first ``cap`` routed tokens of each expert."""
    sel = w > 0
    rank = np.cumsum(sel, axis=0) - 1
    return {(int(t), int(e)) for t, e in zip(*np.nonzero(sel & (rank < cap)))}


def _cap(cfg, n):
    c = int(np.ceil(n * cfg.experts_per_token / cfg.n_experts
                    * cfg.moe_capacity_factor))
    return min(max(8, -(-c // 8) * 8), n)


@pytest.fixture(scope="module")
def jax_forwards():
    """variant -> (flat params, logits per call, K codes, the x of every
    act_quant matmul per forward call, the capacity dispatch's kept pairs
    per MoE call), the last two through host callbacks in the jitted
    forward."""
    out = {}
    real_mm, real_route = jllama.dequant_matmul_reference, jllama.moe_route
    for variant in _VARIANTS:
        jc, _ = _cfgs(variant)
        jp = jllama.init_params(jc, seed=5)
        xs, kept, call = [], [], [0]

        def watched(x, qt, out_dtype=None, act_quant=False):
            if act_quant:
                jax.debug.callback(
                    lambda v: xs.append((call[0], np.asarray(v))), x,
                    ordered=True)
            return real_mm(x, qt, out_dtype, act_quant=act_quant)

        def route(x, router, cfg, bias=None):
            w = real_route(x, router, cfg, bias=bias)
            n = int(np.prod(x.shape[:-1]))
            if n * cfg.experts_per_token >= 2 * cfg.n_experts:
                cap = _cap(cfg, n)
                jax.debug.callback(lambda v: kept.append(_kept_pairs(
                    np.asarray(v).reshape(n, -1), cap)), w, ordered=True)
            return w

        jllama.dequant_matmul_reference, jllama.moe_route = watched, route
        try:
            fwd = jax.jit(jllama.forward, static_argnames=("cfg",))
            cache = jllama.init_cache(jc, B, MAX_SEQ)
            outs = []
            for tok in _tokens(jc.vocab_size):
                lg, cache = fwd(jp, jnp.asarray(tok), cache, cfg=jc)
                outs.append(np.asarray(lg, np.float32))
                jax.effects_barrier()
                call[0] += 1
        finally:
            jllama.dequant_matmul_reference = real_mm
            jllama.moe_route = real_route
        out[variant] = (_flat(jp), outs, _kv(cache), xs, kept)
    return out


def _selection_margin(x, router, cfg, bias) -> float:
    """The smallest gap between the k-th and (k+1)-th selection score (and,
    under group-limited routing, between the groups kept and the best group
    dropped) of one ``moe_route`` call. Softmax scores without a bias are
    ranked as their logits, so the gap is taken between logits there (a
    tail probability's gap is tiny however far apart its logits are)."""
    logits = x.float() @ router.float()
    if cfg.score_fn == "sigmoid":
        sel = torch.sigmoid(logits)
    else:
        sel = torch.softmax(logits, dim=-1) if bias is not None else logits
    sel = sel if bias is None else sel + bias
    margin = np.inf
    if cfg.n_expert_groups:
        gsel = sel.reshape(sel.shape[:-1] + (cfg.n_expert_groups, -1))
        top = gsel.topk(2, dim=-1).values
        gscore = top.sum(-1) if cfg.group_score == "top2sum" else top[..., 0]
        gs = gscore.sort(dim=-1, descending=True).values
        g = cfg.topk_groups
        margin = float((gs[..., g - 1] - gs[..., g]).min())
        keep = torch.zeros_like(gscore).scatter_(
            -1, gscore.topk(g, dim=-1).indices, 1.0)
        sel = torch.where(keep[..., None] > 0, gsel,
                          torch.zeros_like(gsel)).reshape(sel.shape)
    s = sel.sort(dim=-1, descending=True).values
    k = cfg.experts_per_token
    return min(margin, float((s[..., k - 1] - s[..., k]).min()))


def _port_run(flat, tc, monkeypatch):
    """Logits per call, the cache, the x of every act_quant matmul per
    call, the kept (token, expert) pairs per capacity call, and the
    smallest routing margin."""
    params = params_from_flat(flat, tc, "cpu")
    xs, kept, margins, call = [], [], [], [0]
    real_q, real_slots = (dmm_mod.act_quant_int8_reference,
                          tllama.capacity_slots)
    real_route = tllama.moe_route

    def watched(x, g):
        xs.append((call[0], x.float().numpy().copy()))
        return real_q(x, g)

    def slots(w2, cap):
        st, sw = real_slots(w2, cap)
        kept.append({(int(t), e) for e in range(st.shape[0])
                     for t, v in zip(st[e].tolist(), sw[e].tolist())
                     if v > 0})
        return st, sw

    def route(x, router, cfg, bias=None):
        margins.append(_selection_margin(x, router, cfg, bias))
        return real_route(x, router, cfg, bias)

    monkeypatch.setattr(dmm_mod, "act_quant_int8_reference", watched)
    monkeypatch.setattr(tllama, "capacity_slots", slots)
    monkeypatch.setattr(tllama, "moe_route", route)
    cache = tllama.init_cache(tc, B, MAX_SEQ, "cpu")
    outs = []
    for tok in _tokens(tc.vocab_size):
        lg, cache = tllama.forward(params, torch.from_numpy(tok), cache, tc,
                                   device="cpu")
        outs.append(lg.float().numpy())
        call[0] += 1
    monkeypatch.undo()
    return outs, cache, xs, kept, min(margins)


def _aq_flip_calls(j_xs, t_xs, g) -> np.ndarray:
    """[forward calls]: calls in which some act_quant input sits on another
    int8 code in the two packages. The calls' inputs are matched by shape
    and value, each JAX input to the nearest unmatched port input (the
    packages run their matmuls in other orders: the port's grouped slots
    and its shared experts after the routed ones, JAX's per-expert loop);
    a match must lie within 1e-2 of its max (inputs downstream of a KV code
    tie differ by more than rounding). The first call with a differing code
    and every later one count, and no later input is matched."""
    flips = np.zeros(1 + STEPS, bool)
    for c in range(1 + STEPS):
        js = [x.reshape(-1, x.shape[-1]) for i, x in j_xs if i == c]
        ts = [x for i, x in t_xs if i == c]
        used = set()
        for jx in js:                   # in JAX's order of execution
            best, err = None, np.inf
            for i, tx in enumerate(ts):
                if i in used or tx.shape != jx.shape:
                    continue
                e = np.abs(tx - jx).max()
                if e < err:
                    best, err = i, e
            assert best is not None and err <= 1e-2 * max(
                np.abs(jx).max(), 1e-30), (c, jx.shape, err)
            used.add(best)
            if (_codes(jx, g) != _codes(ts[best], g)).any():
                # every later input may stand a code step apart
                flips[c:] = True
                return flips
    return flips


def _fold_flips(loop_xs, fused_xs, kd: int, g: int) -> np.ndarray:
    """[forward calls]: calls in which a down projection's input sits on
    another int8 code in the fused dispatch (routing weights folded into x
    before ``psum``, as the JAX kernel path folds them) than in the
    per-expert loop (weights applied to the output): the fused inputs'
    routed rows (the others are zero) against the loop's same rows."""
    flips = np.zeros(1 + STEPS, bool)
    for c in range(1 + STEPS):
        lo = [x for i, x in loop_xs if i == c and x.shape[1] == kd]
        fu = [x for i, x in fused_xs if i == c and x.shape[1] == kd]
        assert len(lo) == len(fu) > 0
        for a, b in zip(lo, fu):
            live = b.any(-1)
            if live.any():
                flips[c] |= bool((_codes(a[live], g)
                                  != _codes(b[live], g)).any())
    return flips


def _kv(cache) -> np.ndarray:
    """K and V codes side by side, [L, B, H, S, Dk + Dv] (an MLA cache's V
    side is empty)."""
    return np.concatenate([np.asarray(cache.k_codes),
                           np.asarray(cache.v_codes)], axis=-1)


def _check_logits(ref, got, j_codes, t_codes, flips):
    """Logits within 1e-4 of max|logit|; within 1e-2 in a slot from its
    first K or V code that differs by one step on (a rounding tie of
    ``quantize_kv``; at most 1e-2 of the codes), and everywhere from a
    forward call with an activation code that differs (``flips``; the codes
    that call and later ones write are not held to one step)."""
    first = int(np.argmax(flips)) if flips.any() else 1 + STEPS
    s_held = 0 if first == 0 else T + first - 1   # positions written before
    d = np.abs(t_codes.astype(np.int32)
               - j_codes.astype(np.int32))[:, :, :, :s_held]
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-2 * max(d.size, 1)
    tainted = np.zeros(t_codes.shape[1:4:2], bool)          # [B, S]
    tainted[:, :s_held] = np.cumsum(d.any(axis=(0, 2, 4)), axis=1) > 0
    pos0 = 0
    for c, (r, g) in enumerate(zip(ref, got)):
        assert r.shape == g.shape and np.isfinite(g).all()
        err = np.max(np.abs(r - g), axis=-1) / np.max(np.abs(r))
        sl = slice(pos0, pos0 + r.shape[1])
        tol = np.where(tainted[:, sl] | (c >= first), 1e-2, 1e-4)
        assert np.all(err <= tol), (c, err.max())
        pos0 += r.shape[1]


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_forward_matches_jax(jax_forwards, monkeypatch, variant):
    flat, ref, j_codes, j_xs, j_kept = jax_forwards[variant]
    for mode in _VARIANTS[variant][2]:
        jc, tc = _cfgs(variant, mode)
        got, cache, t_xs, t_kept, margin = _port_run(flat, tc, monkeypatch)
        assert margin >= 1e-5, margin
        flips = np.zeros(1 + STEPS, bool)
        if tc.act_quant and tc.moe_prefill != "capacity":
            # the fused dispatch's down inputs against the loop's, the
            # loop's against JAX's
            loop = _port_run(flat, dataclasses.replace(tc, moe_fused=False),
                             monkeypatch)[2]
            flips = (_fold_flips(loop, t_xs, tllama._padded_k(
                jc.intermediate), tc.group_size)
                | _aq_flip_calls(j_xs, loop, tc.group_size))
        elif tc.act_quant:
            flips = _aq_flip_calls(j_xs, t_xs, tc.group_size)
        assert bool(t_xs) == tc.act_quant
        _check_logits(ref, got, j_codes, _kv(cache), flips)
        if tc.moe_prefill != "capacity":
            continue
        # every MoE layer of every call took the capacity dispatch, and
        # kept the pairs JAX's routing keeps
        n_moe = jc.n_layers - jc.first_k_dense
        assert len(t_kept) == len(j_kept) == n_moe * (1 + STEPS)
        assert t_kept == j_kept
        routed = B * T * jc.experts_per_token
        dropped = [routed - len(kp) for kp in t_kept[:n_moe]]
        if tc.moe_capacity_factor < 1:
            assert min(dropped) > 0, dropped     # the prefill drops tokens
        else:
            assert max(dropped) == 0, dropped


def test_per_expert_loop_matches_fused(jax_forwards, monkeypatch):
    """``moe_fused=False`` (the loop over all E experts through
    ``dequant_matmul``, no host sync) against the fused dispatch, dense and
    capacity, in the port's kernel mode; and W4A8 through the loop against
    JAX (whose xla mode runs the same loop), with the act_quant tie rule."""
    flat, ref, j_codes, j_xs, _ = jax_forwards["w4a8"]
    _, tc = _cfgs("w4a8", "auto", moe_fused=False)
    got, cache, t_xs, _, margin = _port_run(flat, tc, monkeypatch)
    assert margin >= 1e-5
    _check_logits(ref, got, j_codes, _kv(cache),
                  _aq_flip_calls(j_xs, t_xs, tc.group_size))
    flat = jax_forwards["cap4"][0]
    for change in ({}, {"moe_prefill": "capacity",
                        "moe_capacity_factor": 4.0}):
        runs = [_port_run(flat, dataclasses.replace(
            _cfgs("cap4", "auto")[1], moe_fused=fused, **change),
            monkeypatch)[0] for fused in (True, False)]
        for a, b in zip(*runs):
            assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))
    # W4A8 grouped (shared experts, dense prefix) against the loop
    flat = jax_forwards["dsv3-cap4"][0]
    runs = [_port_run(flat, _cfgs("dsv3-cap4", mode, act_quant=True)[1],
                      monkeypatch)[0] for mode in ("auto", "xla")]
    for a, b in zip(*runs):
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))


# ── engine and CLI ──────────────────────────────────────────────────────

_ENGINES = {"contiguous": dict(max_slots=4, max_seq=48, eos_id=-1),
            "paged": dict(max_slots=4, max_seq=48, eos_id=-1, paged=True,
                          page_size=8)}


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(3, 512, n)] for n in (5, 11, 3, 9)]


def _drive(eng, make_req):
    reqs = [make_req(req_id=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX contiguous engine's greedy streams, the reference of both of
    the port's engines (the JAX paged engine gives the same streams on
    these requests, and its compiles cost seconds a run)."""
    jc, _ = _cfgs("cap4")
    jp = jllama.init_params(jc, seed=0)
    return jp, _drive(JEngine(jp, jc, **_ENGINES["contiguous"]), JRequest)


@pytest.mark.parametrize("kind", list(_ENGINES))
def test_capacity_engine_matches_jax(jax_engine, monkeypatch, kind):
    """Greedy streams token-identical at cf 4 (no drops, so JAX's bucket
    padding of prefill chunks does not change the dispatch's result); the
    capacity dispatch runs at the prefill chunks and at the B=4 decode
    steps."""
    jp, streams = jax_engine
    _, tc = _cfgs("cap4", "auto")
    calls = []
    real = tllama._moe_capacity

    def spy(x, *a, **kw):
        calls.append(tuple(x.shape[:2]))
        return real(x, *a, **kw)
    monkeypatch.setattr(tllama, "_moe_capacity", spy)
    eng = TEngine(params_from_flat(_flat(jp), tc, "cpu"), tc, device="cpu",
                  **_ENGINES[kind])
    got = _drive(eng, TRequest)
    assert got == streams and all(len(o) == 5 for o in got)
    assert (4, 1) in calls and any(t > 1 for _, t in calls)


def test_generate_moe_flags(tmp_path, capsys):
    """``generate --moe-prefill capacity --moe-routed off`` on a
    test-tiny-moe checkpoint: the flags reach the config, and the output
    equals an Engine run at that config."""
    _, tc = _cfgs("cap4", "auto")
    tc = dataclasses.replace(tc, moe_capacity_factor=1.5, moe_prefill="dense")
    params = tllama.init_params(tc, seed=0, device="cpu")
    t_save(tmp_path / "ck", params, tc)
    assert t_cli(["generate", str(tmp_path / "ck"), "--prompt-ids",
                  "1,2,3,4,5;6,7,8,9", "--max-new", "3", "--eos-id", "-1",
                  "--moe-prefill", "capacity", "--moe-routed", "off",
                  "--device", "cpu"]) == 0
    outs = [json.loads(x)["output"]
            for x in capsys.readouterr().out.splitlines()]
    want = dataclasses.replace(tc, moe_prefill="capacity", moe_routed="off")
    eng = TEngine(tllama.init_params(tc, seed=0, device="cpu"), want,
                  max_slots=8, max_seq=1024, eos_id=-1, device="cpu")
    assert outs == eng.generate([[1, 2, 3, 4, 5], [6, 7, 8, 9]],
                                max_new_tokens=3)
    with pytest.raises(SystemExit):
        t_cli(["generate", str(tmp_path / "ck"), "--prompt-ids", "1",
               "--moe-prefill", "sparse", "--device", "cpu"])
