"""The port's speculative proposer and rejection sampling against the JAX
reference (CPU).

* ``NgramProposer``: the port's proposals equal JAX's on seeded streams.
* ``spec_commit``: greedy rows give JAX's ``acc`` and committed tokens
  exactly (plain, penalties, a case that the in-window counts alone
  decide, bias, grammar rows, all three, and beside sampled rows); sampled
  rows' first commit follows the filtered target within a total variation
  of 0.02 over 20000 draws, for the delta and the q proposal (JAX's
  inputs, ``tests/test_spec.py``).

The engine's speculation is in ``test_torch_spec.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quant_tpu.engine import sampler as jsampler
from quant_tpu.engine.spec import NgramProposer as JNgram
from quant_tpu_torch.engine import sampler as tsampler
from quant_tpu_torch.engine.spec import NgramProposer as TNgram


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── proposer ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("gamma,max_ngram,min_ngram,history",
                         [(4, 3, 1, 512), (3, 2, 1, 512), (2, 1, 1, 512),
                          (5, 4, 2, 512), (4, 3, 1, 6)])
def test_ngram_matches_jax(gamma, max_ngram, min_ngram, history):
    """JAX's own examples, then 300 seeded streams over small alphabets (so
    n-grams recur) and lengths 0-40: the same proposals."""
    jp = JNgram(gamma, max_ngram, min_ngram, history)
    tp = TNgram(gamma, max_ngram, min_ngram, history)
    rng = np.random.default_rng(gamma * 100 + max_ngram * 10 + history)
    streams = [[5, 6, 7, 8, 9, 1, 2, 5, 6], [5, 1, 5, 2, 5],
               [1, 2, 3, 9, 8, 3, 7, 7, 1, 2, 3], [1, 2, 3, 4], [7], []]
    streams += [[int(t) for t in rng.integers(0, int(a), int(n))]
                for a, n in zip(rng.integers(2, 9, 300),
                                rng.integers(0, 41, 300))]
    got = [tp.propose(s) for s in streams]
    assert got == [jp.propose(s) for s in streams]
    assert sum(map(bool, got)) > 100
    with pytest.raises(ValueError, match="gamma must be >= 1"):
        TNgram(0)
    with pytest.raises(ValueError, match="max_ngram >= min_ngram >= 1"):
        TNgram(2, max_ngram=1, min_ngram=2)


# ── spec_commit ─────────────────────────────────────────────────────────


def _commit_inputs(kind, b=6, g=3, v=64):
    """Random logits; drafts that follow the raw argmax chain for a
    row-dependent prefix, then leave it (so acc takes several values);
    per-row penalties, biases and grammar rows for ``kind``. "window": token
    5 leads every position by a row's margin and every draft is 5, under a
    frequency penalty of 1, so the in-window counts alone end each row's
    accepted run (at the first position whose count exceeds the margin)."""
    rng = np.random.default_rng(7)
    if kind == "window":
        logits = rng.standard_normal((b, g + 1, v)).astype(np.float32)
        margin = 0.3 + 0.4 * np.arange(b, dtype=np.float32)
        logits[:, :, 5] = logits.max(-1) + margin[:, None]
        toks = np.full((b, g + 1), 5)
        toks[:, 0] = 7
        zeros, ones = np.zeros(b, np.float32), np.ones(b, np.float32)
        return logits, toks, {"pen": (np.zeros((b, v), np.int32), ones, ones,
                                      zeros)}
    logits = (rng.standard_normal((b, g + 1, v)) * 3).astype(np.float32)
    am = logits.argmax(-1)
    toks = rng.integers(0, v, (b, g + 1))
    for i in range(b):
        keep = i % (g + 1)
        toks[i, 1:1 + keep] = am[i, :keep]
    kw = {}
    counts = rng.integers(0, 3, (b, v)).astype(np.int32)
    if kind in ("penalties", "all"):
        kw["pen"] = (counts, np.linspace(1.0, 2.0, b).astype(np.float32),
                     np.linspace(0.0, 1.0, b).astype(np.float32),
                     np.linspace(0.0, 1.5, b).astype(np.float32))
    if kind in ("bias", "all"):
        bt = rng.integers(0, v, (b, 5))
        bt[:, 0] = am[:, 1]         # ban what the second position wants
        bv = (rng.standard_normal((b, 5)) * 5).astype(np.float32)
        bv[:, 0] = -100.0
        kw["bias"] = (bt, bv)
    if kind in ("fsm", "all"):
        rows = np.where(rng.random((b, g + 1, v)) < 0.3, -1, 0)
        rows[:, :, 0] = 0           # never an empty row
        kw["fsm"] = rows.astype(np.int32)
    return logits, toks, kw


def _jax_commit(logits, toks, temps, topks, topps, kw, key=0):
    out, acc = jsampler.spec_commit(
        jnp.asarray(logits), jnp.asarray(toks, jnp.int32),
        jax.random.split(jax.random.key(key), logits.shape[0]),
        jnp.asarray(temps), jnp.asarray(topks, jnp.int32), jnp.asarray(topps),
        jnp.zeros_like(jnp.asarray(temps)),
        penalties=(tuple(jnp.asarray(x) for x in kw["pen"])
                   if "pen" in kw else None),
        bias=((jnp.asarray(kw["bias"][0], jnp.int32),
               jnp.asarray(kw["bias"][1])) if "bias" in kw else None),
        fsm_rows=jnp.asarray(kw["fsm"]) if "fsm" in kw else None)
    return np.asarray(out), np.asarray(acc)


def _torch_commit(logits, toks, temps, topks, topps, kw, gens, q=None):
    t = torch.from_numpy
    return tsampler.spec_commit(
        t(logits), t(np.asarray(toks, np.int64)), gens, t(temps),
        t(np.asarray(topks, np.int64)), t(topps), torch.zeros(len(temps)),
        penalties=(tuple(t(x) for x in kw["pen"]) if "pen" in kw else None),
        bias=((t(np.asarray(kw["bias"][0], np.int64)), t(kw["bias"][1]))
              if "bias" in kw else None),
        q_probs=None if q is None else t(q),
        fsm_rows=t(kw["fsm"]) if "fsm" in kw else None)


@pytest.mark.parametrize("kind", ["plain", "penalties", "window", "bias",
                                  "fsm", "all", "mixed"])
def test_spec_commit_greedy_rows_match_jax(kind):
    """Greedy rows: JAX's acc and its committed tokens (positions <= acc)
    exactly; "mixed" puts sampled rows beside them (all features on)."""
    logits, toks, kw = _commit_inputs("all" if kind == "mixed" else kind)
    b = logits.shape[0]
    temps = np.zeros(b, np.float32)
    gens = [None] * b
    if kind == "mixed":
        temps[1::2] = 0.9
        gens = [torch.Generator().manual_seed(i) if temps[i] else None
                for i in range(b)]
    topks, topps = np.zeros(b, np.int64), np.ones(b, np.float32)
    j_out, j_acc = _jax_commit(logits, toks, temps, topks, topps, kw)
    t_out, t_acc = _torch_commit(logits, toks, temps, topks, topps, kw, gens)
    greedy = temps == 0
    assert t_acc.numpy()[greedy].tolist() == j_acc[greedy].tolist()
    for i in np.flatnonzero(greedy):
        a = int(j_acc[i])
        assert t_out[i, :a + 1].tolist() == j_out[i, :a + 1].tolist()
    if kind == "plain":
        assert sorted(set(j_acc.tolist())) == [0, 1, 2, 3]
    if kind == "window":
        assert j_acc.tolist() == [1, 1, 2, 2, 2, 3]
    assert t_out.dtype == torch.int64 and t_acc.shape == (b,)


def _marginal_inputs(form):
    """JAX's inputs of ``test_spec_commit_marginal_distribution`` (delta)
    and ``test_spec_commit_q_proposal_marginal_distribution`` (q)."""
    v, g, b = 8, 2, 3
    temps = np.asarray([1.0, 0.7, 0.0], np.float32)
    topks = np.asarray([0, 4, 0], np.int64)
    topps = np.ones(3, np.float32)
    if form == "delta":
        rng = np.random.default_rng(0)
        logits = (rng.standard_normal((b, g + 1, v)) * 1.5).astype(np.float32)
        return logits, temps, topks, topps, None
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((b, g + 1, v)) * 1.5).astype(np.float32)
    q_logits = logits[:, :g] + rng.standard_normal((b, g, v)) * 0.7
    q = np.exp(q_logits) / np.exp(q_logits).sum(-1, keepdims=True)
    am = np.argmax(logits, axis=-1)
    q[2] = np.eye(v)[am[2, :g]] * (1 - 1e-6) + 1e-6 / v
    return logits, temps, topks, topps, q.astype(np.float32)


@pytest.mark.parametrize("form", ["delta", "q"])
def test_spec_commit_sampled_marginal(form):
    """20000 draws at once (the batch tiled, each sampled row its own
    generator): the first commit of each sampled slot within a total
    variation of 0.02 of the filtered target, the greedy slot always the
    argmax. The q form: drafts drawn from q, the greedy slot (q one-hot at
    the argmax) accepts every draft, and slot 0 accepts more than under the
    delta rule on the same drafts."""
    logits, temps, topks, topps, q = _marginal_inputs(form)
    b, gp1, v = logits.shape
    n = 20000
    rng = np.random.default_rng(5)
    if q is None:
        toks = np.tile(np.asarray([[1, 2, 3], [4, 0, 1], [2, 5, 6]]), (n, 1))
    else:
        cdf = np.cumsum(np.tile(q, (n, 1, 1)), -1)
        u = rng.random((n * b, gp1 - 1, 1))
        d = np.minimum((u > cdf).sum(-1), v - 1)
        toks = np.concatenate([np.zeros((n * b, 1), np.int64), d], 1)
    rep = lambda x: np.tile(x, (n,) + (1,) * (x.ndim - 1))   # noqa: E731
    gens = [torch.Generator().manual_seed(k) if temps[k % b] else None
            for k in range(n * b)]
    out, acc = _torch_commit(rep(logits), toks, rep(temps), rep(topks),
                             rep(topps), {}, gens,
                             None if q is None else rep(q))
    out, acc = out.numpy().reshape(n, b, gp1), acc.numpy().reshape(n, b)
    target = np.asarray(jax.nn.softmax(jsampler.filter_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
        jnp.asarray(topps)), axis=-1))
    for slot in range(2):
        emp = np.bincount(out[:, slot, 0], minlength=v) / n
        assert 0.5 * np.abs(emp - target[slot, 0]).sum() < 0.02, slot
    assert np.all(out[:, 2, 0] == np.argmax(logits[2, 0]))
    if q is None:
        assert np.unique(acc[:, 2]).size == 1
        return
    assert acc[:, 2].min() >= gp1 - 1
    gens = [torch.Generator().manual_seed(k) if temps[k % b] else None
            for k in range(n * b)]
    _, acc_delta = _torch_commit(rep(logits), toks, rep(temps), rep(topks),
                                 rep(topps), {}, gens)
    assert acc[:, 0].mean() > acc_delta.numpy().reshape(n, b)[:, 0].mean() \
        + 0.1
