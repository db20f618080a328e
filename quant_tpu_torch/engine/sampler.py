"""Token sampling on torch tensors.

The port of the JAX package's ``engine/sampler.py``: the same
:class:`SamplingConfig`, greedy / temperature / top-k / top-p / min-p
sampling and ``token_logprob``. Randomness comes from explicit
``torch.Generator`` objects (one per engine slot), so the sampled stream
differs from the JAX package's (another generator) while the filtering is
the same. Token-history penalties (:func:`apply_penalties`), OpenAI
``logit_bias`` (:func:`apply_logit_bias`) and grammar (FSM) masks follow
the JAX formulas and order. :func:`spec_commit` is the speculative
verify's rejection sampling (the JAX ``spec_commit``): delta and draft-model
proposals, the penalties counted along the draft, the bias and the grammar
rows, all on the device; each sampled slot draws from its own generator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["SamplingConfig", "apply_logit_bias", "apply_penalties",
           "sample", "filter_logits", "sample_batch", "token_logprob",
           "top_logprobs", "spec_commit"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → disabled
    top_p: float = 1.0         # 1 → disabled
    min_p: float = 0.0         # 0 → disabled; keep p(tok) ≥ min_p·p_max
    # token-history penalties (counts cover prompt + committed output):
    repetition_penalty: float = 1.0  # HF semantics; 1 → disabled
    frequency_penalty: float = 0.0   # OpenAI: logit -= fp·count
    presence_penalty: float = 0.0    # OpenAI: logit -= pp·(count>0)
    # OpenAI logit_bias: ((token_id, bias), ...); -100 effectively bans,
    # +100 effectively forces
    logit_bias: tuple = ()

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.frequency_penalty != 0.0
                or self.presence_penalty != 0.0)


def apply_logit_bias(logits: torch.Tensor, bias_toks: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """Additive per-slot logit bias (OpenAI ``logit_bias``): ``bias_toks``
    ``[B, K]`` ids and ``bias_vals`` ``[B, K]`` f32; unused entries point at
    token 0 with value 0 (a no-op add), repeated ids add up. Applied after
    the penalties, so a -100 ban survives every other adjustment. Logits
    ``[B, V]`` -> f32 ``[B, V]``."""
    lg = logits.to(torch.float32)
    dense = torch.zeros_like(lg)
    rows = torch.arange(lg.shape[0], device=lg.device)[:, None].expand_as(
        bias_toks)
    dense.index_put_((rows, bias_toks.to(torch.int64)),
                     bias_vals.to(torch.float32), accumulate=True)
    return lg + dense


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    reps: torch.Tensor, freqs: torch.Tensor,
                    press: torch.Tensor) -> torch.Tensor:
    """Token-history penalties on RAW logits (before temperature).
    ``counts`` ``[B, V]`` int: occurrences of each token in the slot's
    prompt + committed output; per-slot knobs ``[B]``. Greedy slots honour
    them too (the argmax is taken over the penalized logits):

    * repetition_penalty r (HF): seen & logit>0 → logit/r, seen &
      logit<0 → logit·r
    * frequency/presence (OpenAI): logit -= fp·count + pp·(count>0)
    """
    lg = logits.to(torch.float32)
    seen = counts > 0
    r = reps.to(torch.float32).clamp_min(1e-6)[:, None]
    lg = torch.where(seen, torch.where(lg > 0, lg / r, lg * r), lg)
    return lg - (freqs.to(torch.float32)[:, None] * counts.to(torch.float32)
                 + press.to(torch.float32)[:, None] * seen.to(torch.float32))


def _fsm_mask(logits: torch.Tensor, fsm_rows: torch.Tensor) -> torch.Tensor:
    """-inf where the grammar forbids a token (``fsm_rows`` < 0)."""
    return logits.to(torch.float32).masked_fill(fsm_rows < 0, -math.inf)


def filter_logits(logits: torch.Tensor, temps: torch.Tensor,
                  topks: torch.Tensor, topps: torch.Tensor,
                  minps: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature-scale + top-k / top-p / min-p mask per slot (row) with
    per-slot knobs ``[B]``: logits ``[B, V]`` -> masked, scaled ``[B, V]``
    (masked entries -inf). Same composition as the JAX ``filter_logits``."""
    lg = logits.to(torch.float32)
    v = lg.shape[-1]
    l2 = lg / temps.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(l2, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1,
                       (topks - 1).clamp(0, v - 1).to(torch.int64)[:, None])
    topk_on = (topks > 0)[:, None]
    # masked_fill with a Python scalar: no host-to-device copy, no sync
    neg = -math.inf
    l2 = l2.masked_fill(topk_on & (l2 < kth), neg)
    sorted_desc = sorted_desc.masked_fill(topk_on & (sorted_desc < kth), neg)
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < topps[:, None]).sum(dim=-1).clamp(0, v - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx[:, None])
    l2 = l2.masked_fill((topps < 1.0)[:, None] & (l2 < cutoff), neg)
    if minps is not None:
        mx = l2.amax(dim=-1, keepdim=True)
        thresh = mx + torch.log(minps.clamp_min(1e-38))[:, None]
        l2 = l2.masked_fill((minps > 0.0)[:, None] & (l2 < thresh), neg)
    return l2


def sample_batch(logits: torch.Tensor, temps: torch.Tensor,
                 topks: torch.Tensor, topps: torch.Tensor,
                 minps: torch.Tensor | None, generators, penalties=None,
                 bias=None, fsm_rows: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Per-slot sampling: logits ``[B, V]`` -> ids ``[B]`` (int64).

    ``penalties`` = (counts ``[B, V]``, reps, freqs, press) applies the
    token-history penalties first, ``bias`` = (bias_toks, bias_vals) the
    logit bias after them, and ``fsm_rows`` ``[B, V]`` (0 legal, -1
    forbidden) the grammar mask last, so a forbidden token stays forbidden
    whatever the penalties and the bias did. Rows whose ``generators[b]``
    is None take the argmax of the adjusted logits (``temps[b]`` is 0
    there); the others draw from their filtered distribution with their own
    generator. The row choice is made on the host: no device sync."""
    if penalties is not None:
        logits = apply_penalties(logits, *penalties)
    if bias is not None:
        logits = apply_logit_bias(logits, *bias)
    if fsm_rows is not None:
        logits = _fsm_mask(logits, fsm_rows)
    out = logits.argmax(dim=-1)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return out
    probs = torch.softmax(filter_logits(logits, temps, topks, topps, minps),
                          dim=-1)
    for i in rows:
        out[i] = torch.multinomial(probs[i], 1, generator=generators[i])[0]
    return out


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: torch.Generator | None = None,
           counts: torch.Tensor | None = None,
           fsm_rows: torch.Tensor | None = None) -> torch.Tensor:
    """logits ``[B, V]`` -> ids ``[B]`` under one config. ``counts``
    ``[B, V]`` enables the config's token-history penalties (ignored when
    it has none); ``fsm_rows`` ``[B, V]`` masks the tokens the grammar
    forbids out entirely (the JAX ``sample``: mask, penalties, then the
    bias)."""
    if fsm_rows is not None:
        logits = _fsm_mask(logits, fsm_rows)
    b = logits.shape[0]
    dev = logits.device
    if cfg.has_penalties and counts is not None:
        logits = apply_penalties(
            logits, counts, torch.full((b,), cfg.repetition_penalty,
                                       device=dev),
            torch.full((b,), cfg.frequency_penalty, device=dev),
            torch.full((b,), cfg.presence_penalty, device=dev))
    if cfg.logit_bias:
        toks = torch.tensor([t for t, _ in cfg.logit_bias], device=dev)
        vals = torch.tensor([v for _, v in cfg.logit_bias],
                            dtype=torch.float32, device=dev)
        logits = apply_logit_bias(logits, toks.expand(b, -1),
                                  vals.expand(b, -1))
    if cfg.greedy:
        return logits.argmax(dim=-1)
    l2 = filter_logits(
        logits, torch.full((b,), cfg.temperature, device=dev),
        torch.full((b,), cfg.top_k, device=dev, dtype=torch.int64),
        torch.full((b,), cfg.top_p, device=dev),
        torch.full((b,), cfg.min_p, device=dev) if cfg.min_p > 0 else None)
    return torch.multinomial(torch.softmax(l2, dim=-1), 1,
                             generator=generator)[:, 0]


def token_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(tok) under the raw model distribution (softmax of the
    unfiltered logits). logits ``[..., V]``, toks ``[...]`` -> f32."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    chosen = torch.gather(lg, -1, toks.to(torch.int64)[..., None])[..., 0]
    return chosen - lse


def top_logprobs(logits: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids ``[B, k]`` int64, logprobs ``[B, k]`` f32) of the raw model
    distribution, largest first: the OpenAI top-logprobs payload."""
    lg = logits.to(torch.float32)
    vals, ids = torch.topk(lg, k, dim=-1)
    return ids, vals - torch.logsumexp(lg, dim=-1, keepdim=True)


def spec_commit(logits: torch.Tensor, tokens: torch.Tensor, generators,
                temps: torch.Tensor, topks: torch.Tensor, topps: torch.Tensor,
                minps: torch.Tensor | None = None, penalties=None, bias=None,
                q_probs: torch.Tensor | None = None,
                fsm_rows: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling on the device (the JAX
    ``spec_commit``).

    ``logits`` ``[B, g+1, V]``: the verify forward's; position j predicts
    stream token j+1. ``tokens`` ``[B, g+1]``: the fed tokens, ``tokens[:,
    1:]`` the g drafts. With p_j the adjusted, filtered target distribution
    at position j, a slot accepts draft j with probability p_j(d) (delta
    proposal, ``q_probs`` None: n-gram or greedy drafts) or min(1,
    p_j(d) / q_j(d)) (``q_probs`` ``[B, g, V]``, drafts sampled from q);
    at the first rejection it commits a sample of the residual (p with the
    draft zeroed, or norm((p - q)+)), and after g acceptances a bonus sample
    of p_g. A residual row holding less than 1e-9 of mass falls back to p
    (a rejection there has probability below 1e-9). Both rules are exact
    ancestral sampling of the target chain.

    ``penalties`` = (counts ``[B, V]``, reps, freqs, press): position j adds
    the in-window drafts ``tokens[:, 1..j]`` to counts that already hold
    ``tokens[:, 0]``; ``bias`` = (bias_toks, bias_vals) follows them and
    ``fsm_rows`` ``[B, g+1, V]`` (the grammar rows walked along the draft)
    masks last, so an illegal draft is always rejected. Rows whose
    ``generators[b]`` is None are greedy: they accept while the draft is the
    argmax of the adjusted logits and commit that argmax (their ``temps``
    must be 0). A sampled row draws its g uniforms, then the noise of one
    sample per position, from its own generator in one call. Returns (out
    ``[B, g+1]``, acc ``[B]``), int64: ``out[:, j]`` for j <= acc is the
    committed chain, positions past acc are garbage."""
    b, gp1, v = logits.shape
    g = gp1 - 1
    dev = logits.device
    tokens = tokens.to(torch.int64)

    def rows(x):
        """A per-slot ``[B, ...]`` tensor repeated for each position."""
        return x.repeat_interleave(gp1, dim=0)
    lg = logits.to(torch.float32).reshape(b * gp1, v)
    if penalties is not None:
        counts, reps, freqs, press = penalties
        oh = torch.nn.functional.one_hot(tokens, v).to(counts.dtype)
        cum = torch.cumsum(oh, dim=1) - oh[:, :1]
        lg = apply_penalties(lg, (counts[:, None] + cum).reshape(b * gp1, v),
                             rows(reps), rows(freqs), rows(press))
    if bias is not None:
        lg = apply_logit_bias(lg, rows(bias[0]), rows(bias[1]))
    if fsm_rows is not None:
        lg = _fsm_mask(lg, fsm_rows.reshape(b * gp1, v))
    greedy_tok = lg.argmax(dim=-1).reshape(b, gp1)
    l2 = filter_logits(lg, rows(temps), rows(topks), rows(topps),
                       None if minps is None else rows(minps))
    onehot = torch.nn.functional.one_hot(greedy_tok, v).to(torch.float32)
    probs = torch.where((temps == 0.0)[:, None, None], onehot,
                        torch.softmax(l2, dim=-1).reshape(b, gp1, v))
    # each sampled row's draws, from its own generator in one call: its g
    # uniforms, then the exponential-race noise of one sample a position;
    # rows without a generator take 0.5, which decides a greedy row's
    # acceptance as any uniform does (its p is one-hot: the ratio is 0 or at
    # least 1)
    draws = [None if gen is None else torch.rand(
        g + gp1 * v, generator=gen, device=dev) for gen in generators]
    r = None
    if any(d is not None for d in draws):
        half = torch.full((g + gp1 * v,), 0.5, device=dev)
        r = torch.stack([half if d is None else d for d in draws])
    if g:
        draft = tokens[:, 1:]
        p_draft = torch.gather(probs[:, :g], -1, draft[..., None])[..., 0]
        if q_probs is not None:
            q_draft = torch.gather(q_probs, -1, draft[..., None])[..., 0]
            ratio = p_draft / q_draft.clamp_min(1e-38)
            resid = (probs[:, :g] - q_probs).clamp_min(0.0)
        else:
            ratio = p_draft
            resid = probs[:, :g].scatter(-1, draft[..., None], 0.0)
        u = r[:, :g] if r is not None else torch.full((b, g), 0.5, device=dev)
        acc = torch.cumprod((u < ratio).to(torch.int64), dim=1).sum(dim=1)
        resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid,
                            probs[:, :g])
        dist = torch.cat([resid, probs[:, g:]], dim=1)
    else:
        acc = torch.zeros((b,), dtype=torch.int64, device=dev)
        dist = probs
    samples = greedy_tok
    if r is not None:
        # argmax of dist / Exp(1) noise: a sample of dist at each position
        noise = -torch.log(r[:, g:].reshape(b, gp1, v))
        samples = torch.where((temps == 0.0)[:, None], greedy_tok,
                              (dist / noise).argmax(dim=-1))
    pos = torch.arange(gp1, device=dev)[None]
    out = torch.where(pos < acc[:, None],
                      torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1),
                      samples)
    return out, acc
