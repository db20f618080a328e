"""Token sampling on torch tensors.

The port of the JAX package's ``engine/sampler.py``: the same
:class:`SamplingConfig`, greedy / temperature / top-k / top-p / min-p
sampling and ``token_logprob``. Randomness comes from explicit
``torch.Generator`` objects (one per engine slot), so the sampled stream
differs from the JAX package's (another generator) while the filtering is
the same. Penalties, ``logit_bias``, grammar (FSM) masks and speculative
commits are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["SamplingConfig", "sample", "filter_logits", "sample_batch",
           "token_logprob", "spec_commit"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → disabled
    top_p: float = 1.0         # 1 → disabled
    min_p: float = 0.0         # 0 → disabled; keep p(tok) ≥ min_p·p_max
    # token-history penalties (not ported: must stay at their defaults)
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # OpenAI logit_bias ((token_id, bias), ...) (not ported: must be empty)
    logit_bias: tuple = ()

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.frequency_penalty != 0.0
                or self.presence_penalty != 0.0)


def check_supported(cfg: SamplingConfig) -> None:
    if cfg.has_penalties:
        raise NotImplementedError("sampling penalties are not ported")
    if cfg.logit_bias:
        raise NotImplementedError("logit_bias is not ported")


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
    neg = torch.tensor(-math.inf, device=lg.device)
    l2 = torch.where(topk_on & (l2 < kth), neg, l2)
    sorted_desc = torch.where(topk_on & (sorted_desc < kth), neg, sorted_desc)
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < topps[:, None]).sum(dim=-1).clamp(0, v - 1)
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx[:, None])
    l2 = torch.where((topps < 1.0)[:, None] & (l2 < cutoff), neg, l2)
    if minps is not None:
        mx = l2.amax(dim=-1, keepdim=True)
        thresh = mx + torch.log(minps.clamp_min(1e-38))[:, None]
        l2 = torch.where((minps > 0.0)[:, None] & (l2 < thresh), neg, l2)
    return l2


def sample_batch(logits: torch.Tensor, temps: torch.Tensor,
                 topks: torch.Tensor, topps: torch.Tensor,
                 minps: torch.Tensor | None, generators) -> torch.Tensor:
    """Per-slot sampling: logits ``[B, V]`` -> ids ``[B]`` (int64).
    Rows whose ``generators[b]`` is None take the argmax (``temps[b]`` is 0
    there); the others draw from their filtered distribution with their
    own generator. The row choice is made on the host: no device sync."""
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
           generator: torch.Generator | None = None, counts=None,
           fsm_rows=None) -> torch.Tensor:
    """logits ``[B, V]`` -> ids ``[B]`` under one config."""
    check_supported(cfg)
    if counts is not None or fsm_rows is not None:
        raise NotImplementedError("penalty counts and FSM masks are not "
                                  "ported")
    if cfg.greedy:
        return logits.argmax(dim=-1)
    b = logits.shape[0]
    dev = logits.device
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


def spec_commit(*args, **kwargs):
    """Speculative rejection sampling: not ported yet."""
    raise NotImplementedError("speculative decoding is not ported")
