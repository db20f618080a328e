"""Continuous-batching inference engine on one device, no mesh.

The port of the JAX package's ``engine/engine.py`` (``Engine``) for the
int8 cache, contiguous or paged:

* **prefill** — one prompt chunk (up to ``PREFILL_CHUNK`` tokens) of one
  request through a batch-1 forward into a standalone single-slot cache.
  At most one chunk per ``step()`` (admission budget), so active slots keep
  decoding between chunks.
* **insert** — the finished single-slot cache is copied into its slot of
  the decode cache (:meth:`Engine._insert_single`), or scattered into the
  slot's pages of the pool (:meth:`Engine._insert_paged`).
* **decode** — every one of ``max_slots`` slots advances one token per
  forward; ``step_block(n)`` runs n such forwards with the sampled tokens
  staying on the device and fetches them once. Inactive slots compute
  masked garbage; their cache writes past ``max_seq`` are dropped, and a
  pool's parked slots write into its scratch page 0.

``paged=True`` keeps the KV cache in a pool of ``n_pages`` pages of
``page_size`` tokens (:class:`~quant_tpu_torch.models.llama.PagedKVCache`)
with a free-list allocator on the host: pages are allocated as slots grow,
and when the pool runs out the newest slot is preempted and later resumes
by prefilling ``prompt + output`` (its generator state travels with it, so
a sampled stream continues where it stopped). ``prefix_cache=True`` (needs
``paged``) shares the pages of full, page-aligned prompt blocks between
requests: blocks are keyed by a chained blake2b digest, admission reuses
matching pages and prefills only the suffix directly into the slot's own
pages, and pages whose blocks stay cached become evictable (LRU) instead of
free when their last user finishes.

PyTorch runs eagerly, so there are no per-shape programs: a chunk is run at
its true length (the JAX engine pads chunks to power-of-two buckets for its
jit shapes). Each slot owns a ``torch.Generator`` seeded from the request's
``seed`` (or ``req_id``), so a sampled stream does not depend on co-batched
traffic. Meshes, speculation, LoRA, grammar FSMs, top-logprobs and
embeddings raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
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
    # the slot generator's state when the request was preempted (paged
    # engine); its re-admission continues the stream from there
    gen_state: torch.Tensor | None = None
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
                 paged: bool = False, page_size: int | None = None,
                 n_pages: int | None = None, prefix_cache: bool = False,
                 spec_gamma: int = 0, loras: dict | None = None):
        unsupported = {"mesh": mesh is not None, "spec_gamma": spec_gamma,
                       "loras": bool(loras)}
        bad = [k for k, on in unsupported.items() if on]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
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
        if page_size is None:
            # the JAX engine's default: the largest of 512 .. 32 that
            # divides max_seq (coarser pages cost prefix sharing and up to
            # page - 1 tokens of slack per slot)
            page_size = next(g for g in (512, 256, 128, 64, 32, max_seq)
                             if max_seq % g == 0)
        self.page_size = page_size
        self.paged = paged
        self.prefix_cache = prefix_cache
        if paged:
            # Page 0 is reserved scratch: freed slots park their table rows
            # there and their lengths at 0, so stale decode writes never
            # land in a page that was handed out again.
            if max_seq % page_size:
                raise ValueError(f"max_seq {max_seq} must divide by "
                                 f"page_size {page_size}")
            if n_pages is None:
                n_pages = 1 + max_slots * (max_seq // page_size)
            self.n_pages = n_pages
            self._free_pages = list(range(n_pages - 1, 0, -1))
            self._page_tbl = np.zeros((max_slots, max_seq // page_size),
                                      np.int32)
            self._n_alloc = np.zeros((max_slots,), np.int64)
            self._admit_seq = np.zeros((max_slots,), np.int64)
            self._admit_counter = 0
            self._release_pending: list[int] = []
            self._tbl_dirty = False
            self.cache = llama.init_paged_cache(cfg, max_slots, max_seq,
                                                n_pages, page_size,
                                                device=self.dev)
        else:
            self.cache = llama.init_cache(cfg, max_slots, max_seq, self.dev)
        if prefix_cache:
            # block key -> page, page -> block key, evictable pages in LRU
            # order (a dict keeps insertion order), page -> slots using it
            # (0 for an evictable page)
            self._prefix_map: dict[bytes, int] = {}
            self._page_key: dict[int, bytes] = {}
            self._evictable: dict[int, None] = {}
            self._page_ref: dict[int, int] = {}
            self._prefix_hit_tokens = 0
            # suffix chunks prefill straight into the pool's pages
            self.pf_cache = None
        else:
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

    def _forward(self, tokens: torch.Tensor,
                 cache: llama.KVCache | llama.PagedKVCache):
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

    def _insert_paged(self, slot: int) -> None:
        """Scatter the single-slot prefill cache into the slot's pool pages
        (the JAX engine's ``_paged_scatter`` and ``_insert_paged``): its S
        axis cut into page-sized blocks, block j written to page
        ``_page_tbl[slot, j]`` for each of the slot's allocated pages, then
        the slot's length."""
        c, pf, page = self.cache, self.pf_cache, self.page_size
        n = int(self._n_alloc[slot])
        ids = torch.from_numpy(self._page_tbl[slot, :n].astype(np.int64)).to(
            self.dev)
        for pool, a in ((c.k_codes, pf.k_codes), (c.k_scale, pf.k_scale),
                        (c.v_codes, pf.v_codes), (c.v_scale, pf.v_scale)):
            a = a[:, 0, :, :n * page]                  # [L, H, n*page(, D)]
            blocks = a.reshape(a.shape[0], a.shape[1], n, page,
                               *a.shape[3:]).transpose(1, 2)
            pool[:, ids] = blocks                      # [L, n, H, page(, D)]
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
        if self.paged and self._pages_for(
                len(req.prompt) + req.max_new_tokens) > self.n_pages - 1:
            raise ValueError(
                f"request {req.req_id} needs more pages than the pool has")
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
            req = self.pending.pop(0)
            if self.prefix_cache:
                # reuse the longest cached full-block prefix, then allocate
                # the slot's remaining pages up front: suffix chunks write
                # the pool's pages directly
                stream0 = req.prompt + req.output
                off0 = self._match_prefix(free, stream0)
                while not self._ensure_pages(
                        free, min(len(stream0) + 1, self.max_seq)):
                    if not self._preempt_newest():
                        raise RuntimeError(
                            "page pool exhausted with nothing to preempt")
                self._prefilling = [req, free, off0]
            else:
                self.pf_cache.lengths.zero_()
                self._prefilling = [req, free, 0]
        req, slot, off = self._prefilling
        # a preempted request resumes by prefilling everything it had
        # produced so far (paged engine)
        stream = req.prompt + req.output
        chunk = stream[off:off + self.PREFILL_CHUNK]
        toks = torch.tensor([chunk], dtype=torch.int64, device=self.dev)
        if self.prefix_cache:
            # a batch-1 view of the pool through the slot's table row: the
            # chunk attends to the reused prefix pages and writes its KV
            # into the slot's own pages (positions >= off, never a shared
            # page)
            c = self.cache
            view = llama.PagedKVCache(
                k_codes=c.k_codes, k_scale=c.k_scale, v_codes=c.v_codes,
                v_scale=c.v_scale,
                page_tbl=torch.from_numpy(
                    self._page_tbl[slot:slot + 1].copy()).to(self.dev),
                lengths=torch.tensor([off], dtype=torch.int32,
                                     device=self.dev))
            logits, _ = self._forward(toks, view)
        else:
            logits, self.pf_cache = self._forward(toks, self.pf_cache)
        self.prefill_chunks += 1
        off += len(chunk)
        if off < len(stream):
            self._prefilling = [req, slot, off]
            return
        self._complete_admission(req, slot, stream, logits[0, -1])

    def _complete_admission(self, req: Request, slot: int, stream: list,
                            last: torch.Tensor) -> None:
        """Prompt complete: insert into the decode cache, first token."""
        if self.prefix_cache:
            # the KV is already in the pool's pages: publish the new blocks
            # and the slot's length
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            self._register_prefix(slot, stream)
            self._sync_paged()
            self.cache.lengths[slot] = len(stream)
        elif self.paged:
            while not self._ensure_pages(slot, len(stream) + 1):
                if not self._preempt_newest():
                    raise RuntimeError(
                        "page pool exhausted with nothing to preempt")
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            self._sync_paged()
            self._insert_paged(slot)
        else:
            self._insert_single(slot)
        gen = self._gens[slot]
        if req.gen_state is not None:
            gen.set_state(req.gen_state)
            req.gen_state = None
        else:
            seed = req.seed if req.seed is not None else req.req_id
            gen.manual_seed(int(seed) & 0x7FFFFFFF)
        tok_t = sampler.sample(last[None], req.sampling, generator=gen)
        lp = sampler.token_logprob(last[None], tok_t)
        tok = int(tok_t[0])
        req.output.append(tok)
        req.logprobs.append(float(lp[0]))
        req.first_token_t = time.monotonic()
        self.slots[slot] = req
        if self.paged:
            self._tbl_dirty = True    # the slot's table row goes live
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
            if self.paged:
                self._free_slot_pages(i)
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
            if self.prefix_cache:
                # prefix mode allocates the slot's pages when admission
                # starts: release them or they leak
                self._free_slot_pages(self._prefilling[1])
            self._prefilling = None
            return True
        for i, r in enumerate(self.slots):
            if r is not None and r.req_id == req_id:
                r.finished = True
                self.slots[i] = None
                if self.paged:
                    self._free_slot_pages(i)
                return True
        return False

    # ── paged allocator (free list over the page pool) ───────────────

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _block_keys(self, stream: list[int]) -> list[bytes]:
        """Chained digests of the stream's full page-aligned blocks:
        key_j = H(key_{j-1} || tokens of block j), so a match at block j
        certifies the whole prefix (and the KV it produced: positions are
        absolute under RoPE)."""
        page = self.page_size
        keys, h = [], b""
        for j in range(len(stream) // page):
            blk = np.asarray(stream[j * page:(j + 1) * page], np.int32)
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            keys.append(h)
        return keys

    def _match_prefix(self, slot: int, stream: list[int]) -> int:
        """Point the slot's leading table entries at cached pages matching
        the stream's longest full-block prefix; returns the token count
        covered (prefill resumes there). At least one token is always left
        to prefill: its logits seed sampling."""
        page = self.page_size
        max_k = (len(stream) - 1) // page
        k = 0
        for j, key in enumerate(self._block_keys(stream)[:max_k]):
            pg = self._prefix_map.get(key)
            if pg is None:
                break
            if self._page_ref.get(pg, 0) == 0:
                self._evictable.pop(pg, None)   # re-referenced
                self._page_ref[pg] = 1
            else:
                self._page_ref[pg] += 1
            self._page_tbl[slot, j] = pg
            self._tbl_dirty = True
            k = j + 1
        self._n_alloc[slot] = k
        self._prefix_hit_tokens += k * page
        return k * page

    def _register_prefix(self, slot: int, stream: list[int]) -> None:
        """Publish the slot's filled full blocks into the prefix map (its
        pages now hold exactly those blocks' KV)."""
        for j, key in enumerate(self._block_keys(stream)):
            if key in self._prefix_map:
                continue
            pg = int(self._page_tbl[slot, j])
            if pg in self._page_key:    # page already published (shared)
                continue
            self._prefix_map[key] = pg
            self._page_key[pg] = key

    def _alloc_page(self) -> int | None:
        """A blank page from the free list, else (prefix mode) the least
        recently cached evictable page, whose block leaves the prefix map;
        else None (the caller preempts)."""
        if self._free_pages:
            return self._free_pages.pop()
        if self.prefix_cache and self._evictable:
            pg = next(iter(self._evictable))
            del self._evictable[pg]
            del self._prefix_map[self._page_key.pop(pg)]
            return pg
        return None

    def _ensure_pages(self, slot: int, upto_len: int) -> bool:
        need = self._pages_for(min(upto_len, self.max_seq))
        while self._n_alloc[slot] < need:
            col = int(self._n_alloc[slot])
            pg = self._alloc_page()
            if pg is None:
                return False
            if self.prefix_cache:
                self._page_ref[pg] = 1
            self._page_tbl[slot, col] = pg
            self._n_alloc[slot] += 1
            self._tbl_dirty = True
        return True

    def _free_slot_pages(self, slot: int) -> None:
        for j in range(int(self._n_alloc[slot])):
            pg = int(self._page_tbl[slot, j])
            if self.prefix_cache:
                self._page_ref[pg] -= 1
                if self._page_ref[pg] > 0:
                    continue      # still used by another slot
                if pg in self._page_key:
                    # the block stays cached; the page becomes evictable
                    self._evictable[pg] = None
                    continue
            self._free_pages.append(pg)
        self._page_tbl[slot, :] = 0   # the reserved scratch page
        self._n_alloc[slot] = 0
        self._release_pending.append(slot)
        self._tbl_dirty = True

    def _sync_paged(self) -> None:
        """Push the host's allocator state to the device before the next
        forward: freed slots' lengths go to 0 (their writes park in the
        scratch page 0) and the page table is rewritten when it changed.
        Rows of slots without an active request stay parked at 0 on the
        device, so the decode writes of a slot whose admission is still
        prefilling never reach its (possibly shared) pages."""
        if not self.paged:
            return
        if self._release_pending:
            self.cache.lengths[torch.tensor(self._release_pending,
                                            device=self.dev)] = 0
            self._release_pending = []
        if self._tbl_dirty:
            tbl = self._page_tbl.copy()
            tbl[[i for i, s in enumerate(self.slots) if s is None]] = 0
            self.cache.page_tbl.copy_(torch.from_numpy(tbl))
            self._tbl_dirty = False

    def _preempt_newest(self) -> bool:
        """Evict the most recently admitted slot, returning its pages; the
        request goes back to the head of the queue and resumes later
        (admission prefills prompt + output, and the slot generator's state
        travels with it)."""
        cands = [i for i, s in enumerate(self.slots) if s is not None]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self._admit_seq[i])
        req = self.slots[victim]
        self.slots[victim] = None
        req.gen_state = self._gens[victim].get_state()
        self._free_slot_pages(victim)
        self.pending.insert(0, req)
        log.info("preempt req=%d slot=%d (pool exhausted)", req.req_id,
                 victim)
        return True

    def _grow_for_decode(self, horizon: int) -> None:
        """Allocate pages covering the next ``horizon`` tokens of every
        active slot, preempting the newest slots when the pool runs out."""
        if not self.paged:
            return
        for i in range(self.max_slots):
            while self.slots[i] is not None:
                req = self.slots[i]
                used = len(req.prompt) + len(req.output)
                if self._ensure_pages(i, min(used + horizon, self.max_seq)):
                    break
                if not self._preempt_newest():
                    raise RuntimeError(
                        "page pool exhausted with nothing to preempt")

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
        self._grow_for_decode(1)
        self._sync_paged()
        # _grow_for_decode may have preempted slots
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
        self._grow_for_decode(n)
        self._sync_paged()
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
            **({"prefix_hit_tokens": self._prefix_hit_tokens,
                "cached_blocks": len(self._prefix_map)}
               if self.prefix_cache else {}),
            **({"free_pages": len(self._free_pages),
                "total_pages": self.n_pages - 1}
               if self.paged else {}),
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
