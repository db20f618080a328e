"""Continuous-batching inference engine on one device, no mesh.

The port of the JAX package's ``engine/engine.py`` (``Engine``) for the
contiguous int8 cache:

* **prefill** — one prompt chunk (up to ``PREFILL_CHUNK`` tokens) of one
  request through a batch-1 forward into a standalone single-slot cache.
  At most one chunk per ``step()`` (admission budget), so active slots keep
  decoding between chunks.
* **insert** — the finished single-slot cache is copied into its slot of
  the decode cache (:meth:`Engine._insert_single`).
* **decode** — every one of ``max_slots`` slots advances one token per
  forward; ``step_block(n)`` runs n such forwards with the sampled tokens
  staying on the device and fetches them once. Inactive slots compute
  masked garbage; their cache writes past ``max_seq`` are dropped.

PyTorch runs eagerly, so there are no per-shape programs: a chunk is run at
its true length (the JAX engine pads chunks to power-of-two buckets for its
jit shapes). Each slot owns a ``torch.Generator`` seeded from the request's
``seed`` (or ``req_id``), so a sampled stream does not depend on co-batched
traffic. Meshes, paged KV, prefix caching, speculation, LoRA, grammar FSMs,
top-logprobs and embeddings raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from quant_tpu_torch.engine import sampler
from quant_tpu_torch.engine.sampler import SamplingConfig
from quant_tpu_torch.models import llama
from quant_tpu_torch.models.config import ModelConfig
from quant_tpu_torch.utils.device import check_on, resolve_device

log = logging.getLogger("quant_tpu_torch.engine")

__all__ = ["Engine", "QueueFullError", "Request"]


class QueueFullError(RuntimeError):
    """add_request refused: the pending queue is at max_pending."""


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int
    sampling: SamplingConfig = SamplingConfig()
    # absolute time.monotonic() deadline; None = no deadline
    deadline: float | None = None
    # extra per-request stop tokens (besides the engine's eos_id)
    stop_ids: tuple[int, ...] = ()
    # not ported yet: must stay at their defaults
    fsm: Any = None
    top_logprobs: int = 0
    lora: Any = None
    # per-request seed of the slot's generator; None derives it from req_id
    seed: int | None = None
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    finished: bool = False
    timed_out: bool = False
    submit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None

    @property
    def ttft(self) -> float | None:
        """Time to first token (s); None until the first token lands."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def tpot(self) -> float | None:
        """Mean time per output token after the first (s)."""
        if (self.first_token_t is None or self.finish_t is None
                or len(self.output) < 2):
            return None
        return (self.finish_t - self.first_token_t) / (len(self.output) - 1)


class Engine:
    """Continuous-batching engine over ``max_slots`` decode slots."""

    PREFILL_CHUNK = 512

    def __init__(self, params: llama.LlamaParams, cfg: ModelConfig,
                 max_slots: int = 8, max_seq: int = 1024, eos_id: int = 2,
                 *, device=None, max_pending: int | None = None,
                 block_admit_chunks: int | None = 4, mesh=None,
                 paged: bool = False, prefix_cache: bool = False,
                 spec_gamma: int = 0, loras: dict | None = None):
        unsupported = {"mesh": mesh is not None, "paged": paged,
                       "prefix_cache": prefix_cache, "spec_gamma": spec_gamma,
                       "loras": bool(loras)}
        bad = [k for k, on in unsupported.items() if on]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        llama.check_supported(cfg)
        self.dev = resolve_device(device)
        check_on(params.final_norm, self.dev, "params")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.max_pending = max_pending
        self.block_admit_chunks = block_admit_chunks
        self.cache = llama.init_cache(cfg, max_slots, max_seq, self.dev)
        self.pf_cache = llama.init_cache(cfg, 1, max_seq, self.dev)
        self.slots: list[Request | None] = [None] * max_slots
        self.last_tokens = np.zeros((max_slots,), np.int64)
        self.pending: list[Request] = []
        # in-flight admission: [req, slot, tokens prefilled so far]
        self._prefilling: list | None = None
        # requests that finish during admission (max_new=1 / immediate EOS)
        self._admit_finished: list[Request] = []
        self._gens = [torch.Generator(device=self.dev)
                      for _ in range(max_slots)]
        self._steps = 0
        self._tok_ema = 0.0
        self._last_t = time.perf_counter()
        self._ttfts: collections.deque = collections.deque(maxlen=512)
        self._tpots: collections.deque = collections.deque(maxlen=512)
        # forwards run: each prefill chunk and each decode step is one
        self.prefill_chunks = 0
        self.decode_forwards = 0

    # ── device steps ────────────────────────────────────────────────

    def _forward(self, tokens: torch.Tensor, cache: llama.KVCache):
        return llama.forward(self.params, tokens, cache, self.cfg,
                             device=self.dev)

    def _insert_single(self, slot: int) -> None:
        """Copy the single-slot prefill cache into decode-cache ``slot``."""
        c, pf = self.cache, self.pf_cache
        c.k_codes[:, slot].copy_(pf.k_codes[:, 0])
        c.k_scale[:, slot].copy_(pf.k_scale[:, 0])
        c.v_codes[:, slot].copy_(pf.v_codes[:, 0])
        c.v_scale[:, slot].copy_(pf.v_scale[:, 0])
        c.lengths[slot] = pf.lengths[0]

    def _knobs(self, active):
        """Per-slot sampling knobs on the device + the generator list
        (None for greedy and inactive slots); only a batch with a sampled
        slot needs them."""
        temps = np.zeros((self.max_slots,), np.float32)
        topks = np.zeros((self.max_slots,), np.int64)
        topps = np.ones((self.max_slots,), np.float32)
        minps = np.zeros((self.max_slots,), np.float32)
        for i in active:
            sc = self.slots[i].sampling
            temps[i], topks[i], topps[i], minps[i] = (
                sc.temperature, sc.top_k, sc.top_p, sc.min_p)
        to = lambda a: torch.from_numpy(a).to(self.dev)
        gens = [self._gens[i] if self.slots[i] is not None and temps[i] != 0
                else None for i in range(self.max_slots)]
        return to(temps), to(topks), to(topps), to(minps), gens

    def _decode(self, tokens: torch.Tensor, knobs, sampled: bool):
        """One forward of every slot: tokens [B] -> (next [B], logprob [B])
        on the device."""
        logits, self.cache = self._forward(tokens[:, None], self.cache)
        self.decode_forwards += 1
        lg = logits[:, -1]
        if sampled:
            nxt = sampler.sample_batch(lg, *knobs)
        else:
            nxt = lg.argmax(dim=-1)
        return nxt, sampler.token_logprob(lg, nxt)

    # ── public API ──────────────────────────────────────────────────

    def add_request(self, req: Request) -> None:
        if not req.prompt or any(
                not 0 <= int(t) < self.cfg.vocab_size for t in req.prompt):
            raise ValueError(
                f"request {req.req_id}: prompt ids must be in "
                f"[0, {self.cfg.vocab_size}) and non-empty")
        if req.fsm is not None or req.top_logprobs or req.lora is not None:
            raise NotImplementedError(
                "grammar FSMs, top_logprobs and LoRA are not ported")
        sampler.check_supported(req.sampling)
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.req_id}: prompt({len(req.prompt)}) + "
                f"max_new({req.max_new_tokens}) exceeds max_seq "
                f"{self.max_seq}")
        if (self.max_pending is not None
                and len(self.pending) >= self.max_pending):
            raise QueueFullError(f"pending queue full ({self.max_pending})")
        if req.submit_t is None:
            req.submit_t = time.monotonic()
        self.pending.append(req)

    def _expire_deadlines(self, finished: list[Request]) -> None:
        now = time.monotonic()

        def expired(r):
            return (r is not None and r.deadline is not None
                    and now >= r.deadline and not r.finished)

        for r in [r for r in self.pending if expired(r)]:
            self.pending.remove(r)
            r.finished = r.timed_out = True
            finished.append(r)
        if self._prefilling is not None and expired(self._prefilling[0]):
            r = self._prefilling[0]
            self.cancel(r.req_id)
            r.timed_out = True
            finished.append(r)
        for r in list(self.slots):
            if expired(r):
                self.cancel(r.req_id)
                r.timed_out = True
                finished.append(r)

    def _advance_admission(self) -> None:
        """Run at most ONE prefill chunk (admission budget)."""
        if self._prefilling is None:
            if not self.pending:
                return
            free = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if free is None:
                return
            self.pf_cache.lengths.zero_()
            self._prefilling = [self.pending.pop(0), free, 0]
        req, slot, off = self._prefilling
        chunk = req.prompt[off:off + self.PREFILL_CHUNK]
        toks = torch.tensor([chunk], dtype=torch.int64, device=self.dev)
        logits, self.pf_cache = self._forward(toks, self.pf_cache)
        self.prefill_chunks += 1
        off += len(chunk)
        if off < len(req.prompt):
            self._prefilling = [req, slot, off]
            return
        self._complete_admission(req, slot, logits[0, -1])

    def _complete_admission(self, req: Request, slot: int,
                            last: torch.Tensor) -> None:
        """Prompt complete: insert into the decode cache, first token."""
        self._insert_single(slot)
        seed = req.seed if req.seed is not None else req.req_id
        gen = self._gens[slot]
        gen.manual_seed(int(seed) & 0x7FFFFFFF)
        tok_t = sampler.sample(last[None], req.sampling, generator=gen)
        lp = sampler.token_logprob(last[None], tok_t)
        tok = int(tok_t[0])
        req.output.append(tok)
        req.logprobs.append(float(lp[0]))
        req.first_token_t = time.monotonic()
        self.slots[slot] = req
        self.last_tokens[slot] = tok
        self._maybe_finish(slot, tok)
        if req.finished:
            self._admit_finished.append(req)
        self._prefilling = None
        log.info("admit req=%d slot=%d prompt_len=%d", req.req_id, slot,
                 len(req.prompt))

    def _drain_admission(self, max_chunks: int | None = None) -> None:
        """Admit pending requests, at most ``max_chunks`` prefill chunks."""
        done = 0
        while (self._prefilling is not None
               or (self.pending and any(s is None for s in self.slots))):
            if max_chunks is not None and done >= max_chunks:
                return
            self._advance_admission()
            done += 1

    def _maybe_finish(self, i: int, tok: int) -> None:
        req = self.slots[i]
        if req is None:
            return
        used = len(req.prompt) + len(req.output)
        if (tok == self.eos_id or tok in req.stop_ids
                or len(req.output) >= req.max_new_tokens
                or used >= self.max_seq):
            req.finished = True
            req.finish_t = time.monotonic()
            if req.ttft is not None:
                self._ttfts.append(req.ttft)
            if req.tpot is not None:
                self._tpots.append(req.tpot)
            self.slots[i] = None
            log.info("finish req=%d generated=%d", req.req_id,
                     len(req.output))

    def cancel(self, req_id: int) -> bool:
        """Cancel a pending, prefilling or in-flight request."""
        for i, r in enumerate(self.pending):
            if r.req_id == req_id:
                self.pending.pop(i)
                r.finished = True
                return True
        if (self._prefilling is not None
                and self._prefilling[0].req_id == req_id):
            self._prefilling[0].finished = True
            self._prefilling = None
            return True
        for i, r in enumerate(self.slots):
            if r is not None and r.req_id == req_id:
                r.finished = True
                self.slots[i] = None
                return True
        return False

    def _commit(self, active, toks: np.ndarray, lps: np.ndarray,
                finished: list[Request]) -> None:
        """Append each active slot's tokens (columns of [B, n]) until it
        finishes."""
        for i in active:
            req = self.slots[i]
            for j in range(toks.shape[1]):
                tok = int(toks[i, j])
                req.output.append(tok)
                req.logprobs.append(float(lps[i, j]))
                self.last_tokens[i] = tok
                self._maybe_finish(i, tok)
                if req.finished:
                    finished.append(req)
                    break

    def step(self) -> list[Request]:
        """One prefill chunk of admission (budgeted) + one decode forward
        for all active slots."""
        finished: list[Request] = []
        self._expire_deadlines(finished)
        self._advance_admission()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        finished += self._admit_finished
        self._admit_finished = []
        if active:
            sampled = any(not self.slots[i].sampling.greedy for i in active)
            knobs = self._knobs(active) if sampled else None
            tokens = torch.from_numpy(self.last_tokens).to(self.dev)
            nxt, lp = self._decode(tokens, knobs, sampled)
            self._commit(active, nxt.cpu().numpy()[:, None],
                         lp.cpu().numpy()[:, None], finished)
        self._steps += 1
        now = time.perf_counter()
        rate = len(active) / max(now - self._last_t, 1e-6)
        self._tok_ema = 0.9 * self._tok_ema + 0.1 * rate
        self._last_t = now
        return finished

    def step_block(self, n: int) -> list[Request]:
        """Up to n decode forwards with the tokens kept on the device and
        fetched once; pending requests are admitted first (at most
        ``block_admit_chunks`` chunks while slots are decoding). ``n`` is
        capped by the longest-remaining active slot."""
        finished: list[Request] = []
        self._expire_deadlines(finished)
        self._drain_admission(
            self.block_admit_chunks
            if any(s is not None for s in self.slots) else None)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        finished += self._admit_finished
        self._admit_finished = []
        if not active:
            return finished
        n = max(1, min(n, max(self.slots[i].max_new_tokens
                              - len(self.slots[i].output) for i in active)))
        sampled = any(not self.slots[i].sampling.greedy for i in active)
        knobs = self._knobs(active) if sampled else None
        tokens = torch.from_numpy(self.last_tokens).to(self.dev)
        outs, lps = [], []
        for _ in range(n):
            tokens, lp = self._decode(tokens, knobs, sampled)
            outs.append(tokens)
            lps.append(lp)
        self._commit(active, torch.stack(outs, 1).cpu().numpy(),
                     torch.stack(lps, 1).cpu().numpy(), finished)
        self._steps += n
        return finished

    @staticmethod
    def _pcts(xs, name) -> dict:
        if not xs:
            return {}
        a = np.asarray(xs, np.float64)
        return {f"{name}_p50_ms": round(float(np.percentile(a, 50)) * 1e3, 2),
                f"{name}_p90_ms": round(float(np.percentile(a, 90)) * 1e3, 2),
                f"{name}_p99_ms": round(float(np.percentile(a, 99)) * 1e3, 2)}

    @property
    def stats(self) -> dict:
        return {
            "steps": self._steps,
            "occupancy": sum(s is not None for s in self.slots),
            "pending": len(self.pending)
            + (1 if self._prefilling is not None else 0),
            "tokens_per_s_ema": round(self._tok_ema, 1),
            "prefill_chunks": self.prefill_chunks,
            "decode_forwards": self.decode_forwards,
            **self._pcts(self._ttfts, "ttft"),
            **self._pcts(self._tpots, "tpot"),
        }

    def embed(self, prompt_ids):
        """Mean-pooled prompt embeddings: not ported yet."""
        raise NotImplementedError("embeddings are not ported")

    def has_work(self) -> bool:
        return (bool(self.pending) or self._prefilling is not None
                or any(s is not None for s in self.slots))

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 sampling: SamplingConfig = SamplingConfig()
                 ) -> list[list[int]]:
        """Batch API over the continuous-batching loop (``step_block(16)``
        until every request is done)."""
        reqs = [Request(req_id=i, prompt=p, max_new_tokens=max_new_tokens,
                        sampling=sampling) for i, p in enumerate(prompts)]
        for r in reqs:
            self.add_request(r)
        while self.has_work():
            self.step_block(16)
        return [r.output for r in reqs]
