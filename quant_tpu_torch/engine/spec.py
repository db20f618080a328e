"""Speculative decoding: the draft proposers (the JAX package's
``engine/spec.py``).

The engine's verify step feeds every slot's last committed token and
``gamma`` drafts through one T=gamma+1 forward of the target and commits the
accepted prefix plus one token (``sampler.spec_commit``): greedy slots keep
exactly the target's argmax chain, whatever the proposer, and sampled slots
its exact sampling chain. Acceptance changes only how many tokens a verify
commits. The T=1 decode and the T=gamma+1 verify round differently (other
matmul tiles on the card), so a near-tie of the argmax can fall the other
way between them: the speculative stream is greedy under the verify's
rounding.

* :class:`NgramProposer` (prompt lookup): the continuation after the most
  recent earlier occurrence of the stream's longest suffix n-gram, on the
  host, in microseconds.
* :class:`DraftModelProposer`: a small model of the same vocabulary drafts
  ``gamma`` tokens in a chain of T=1 forwards over its own ``[max_slots]``
  cache, on the device. Its cache holds the KV of ``stream[:-1]`` before a
  round; the chain feeds the last token and then its own drafts, and an
  extra last forward writes the KV of the last draft. The accepted prefix is
  the draft prefix (for greedy acceptance and for rejection sampling with
  either proposal), so setting the lengths to ``len(stream) - 1`` at the
  next round is the whole rollback: the one token that may differ from the
  drafts, the commit, is the stream's last. Inactive slots get ``max_seq``,
  so their writes drop. The sampled chain draws d ~ q under each request's
  own knobs and keeps the q rows ``[B, gamma, V]`` on the device for the
  verify's min(1, p/q) rule.
"""

from __future__ import annotations

import dataclasses

import torch

from quant_tpu_torch.engine import sampler
from quant_tpu_torch.models import llama
from quant_tpu_torch.utils.device import check_on, resolve_device

__all__ = ["DraftModelProposer", "NgramProposer"]

# mixed into a request's seed for its draft generator, so the draft chain's
# draws never repeat the engine's sampling draws
_DRAFT_DOMAIN = 0xD4A77 << 32


class DraftModelProposer:
    """Draft-model proposals: ``gamma`` tokens a slot per engine step from
    a chain of ``gamma + 1`` T=1 forwards of the draft over its own cache
    (the module docstring). ``admit`` prefills ``stream[:-1]`` of a newly
    admitted or resumed slot through a batch-1 cache at true chunk lengths
    and copies it into the slot's row."""

    def __init__(self, draft_params: llama.LlamaParams, draft_cfg,
                 gamma: int = 4, max_slots: int = 8, max_seq: int = 1024,
                 prefill_chunk: int = 512, device=None):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.dev = resolve_device(device)
        check_on(draft_params.final_norm, self.dev, "draft params")
        self.gamma = gamma
        self.params = draft_params
        self.cfg = draft_cfg
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.cache = llama.init_cache(draft_cfg, max_slots, max_seq, self.dev)
        self._pf = llama.init_cache(draft_cfg, 1, max_seq, self.dev)
        # each slot's draft-chain generator, seeded from the request's seed
        self._gens = [torch.Generator(device=self.dev)
                      for _ in range(max_slots)]
        # the draft's forwards so far: admission prefill chunks and T=1
        # chain steps
        self.prefill_chunks = 0
        self.chain_forwards = 0

    def _forward(self, tokens, cache, chain: bool = True):
        if chain:
            self.chain_forwards += 1
        else:
            self.prefill_chunks += 1
        return llama.forward(self.params, tokens, cache, self.cfg,
                             device=self.dev)

    def admit(self, slot: int, stream: list[int]) -> None:
        """Prefill ``stream[:-1]`` into the slot's row of the draft cache."""
        ctx = stream[:-1]
        self._pf.lengths.zero_()
        for off in range(0, len(ctx), self.prefill_chunk):
            chunk = ctx[off:off + self.prefill_chunk]
            toks = torch.tensor([chunk], dtype=torch.int64, device=self.dev)
            _, self._pf = self._forward(toks, self._pf, chain=False)
        c, pf = self.cache, self._pf
        for dst, src in ((c.k_codes, pf.k_codes), (c.k_scale, pf.k_scale),
                         (c.v_codes, pf.v_codes), (c.v_scale, pf.v_scale)):
            dst[:, slot].copy_(src[:, 0])
        c.lengths[slot] = pf.lengths[0]

    def set_slot_key(self, slot: int, seed: int) -> None:
        """Seed the slot's draft generator from the request's seed (the
        engine calls it at admission)."""
        self._gens[slot].manual_seed(_DRAFT_DOMAIN | (int(seed) & 0x7FFFFFFF))

    def _start(self, last_tokens, stream_lens) -> torch.Tensor:
        """Roll back: lengths ``len(stream) - 1`` for active slots (``stream
        _lens`` above 0), ``max_seq`` for the others. Returns the fed
        tokens ``[B, 1]``."""
        lens = torch.as_tensor(stream_lens, device=self.dev)
        self.cache = dataclasses.replace(
            self.cache, lengths=torch.where(lens > 0, lens - 1,
                                            self.max_seq).to(torch.int32))
        return torch.as_tensor(last_tokens, device=self.dev).to(
            torch.int64)[:, None]

    def draft_batch(self, last_tokens, stream_lens) -> torch.Tensor:
        """Greedy drafts of every slot: ``last_tokens`` and ``stream_lens``
        ``[max_slots]`` (host or device; 0 for an inactive slot) ->
        ``[max_slots, gamma]`` int64 on the device."""
        tok = self._start(last_tokens, stream_lens)
        out = []
        for _ in range(self.gamma + 1):
            logits, self.cache = self._forward(tok, self.cache)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        # the last forward only wrote the last draft's KV
        return torch.cat(out[:self.gamma], dim=1)

    def draft_batch_sampled(self, last_tokens, stream_lens, temps, topks,
                            topps, minps, rows
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sampled chain: slots ``rows`` draw each draft from their
        filtered distribution q (``temps``, ``topks``, ``topps``, ``minps``
        ``[max_slots]`` on the device) with their draft generator, the
        others take the argmax (one-hot q). Returns (drafts ``[max_slots,
        gamma]`` int64, q ``[max_slots, gamma, V]`` f32), both on the
        device."""
        tok = self._start(last_tokens, stream_lens)
        gens = [None] * len(self._gens)
        for i in rows:
            gens[i] = self._gens[i]
        out, qs = [], []
        for i in range(self.gamma + 1):
            logits, self.cache = self._forward(tok, self.cache)
            if i == self.gamma:
                break
            lg = logits[:, -1]
            tok = sampler.sample_batch(lg, temps, topks, topps, minps,
                                       gens)[:, None]
            onehot = torch.nn.functional.one_hot(
                lg.argmax(dim=-1), lg.shape[-1]).to(torch.float32)
            q = torch.softmax(
                sampler.filter_logits(lg, temps, topks, topps, minps), -1)
            qs.append(torch.where((temps == 0.0)[:, None], onehot, q))
            out.append(tok)
        return torch.cat(out, dim=1), torch.stack(qs, dim=1)


class NgramProposer:
    """Prompt-lookup drafting: the continuation of the most recent earlier
    occurrence of the stream's suffix n-gram, ``max_ngram`` down to
    ``min_ngram`` tried longest first; the first n-gram with an earlier
    occurrence wins. At most ``gamma`` tokens, maybe none (the engine pads;
    padded drafts just fail verification). The backward scan covers the
    last ``history`` tokens."""

    def __init__(self, gamma: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1, history: int = 512):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need max_ngram >= min_ngram >= 1")
        self.gamma = gamma
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.history = history

    def propose(self, stream: list[int]) -> list[int]:
        n = len(stream)
        lo = max(0, n - self.history)
        for k in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = stream[n - k:]
            for start in range(n - k - 1, lo - 1, -1):
                if stream[start:start + k] == suffix:
                    cont = stream[start + k:start + k + self.gamma]
                    if cont:
                        return cont
                    break   # the suffix recurs only at the very end
        return []
