"""Continuous-batching inference engine on one device, no mesh.

The port of the JAX package's ``engine/engine.py`` (``Engine``) for the
int8 cache, contiguous or paged:

* **prefill** — one prompt chunk (up to ``PREFILL_CHUNK`` tokens) of one
  request through a batch-1 forward into a standalone single-slot cache.
  At most one chunk per ``step()`` (admission budget), so active slots keep
  decoding between chunks.
* **insert** — the finished single-slot cache is copied into its slot of
  the decode cache (:meth:`Engine._insert_single`; an MLA cache's
  zero-width V rows copy unchanged), or scattered into the slot's pages of
  the pool (:meth:`Engine._insert_paged`; an MLA latent pool's zero-width
  V pages alike).
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
traffic.

Per-request serving features live on the device beside the decode, as in
the JAX engine: the slots' sampling knobs, penalty knobs and ``logit_bias``
rows (written once at admission), the token-history ``counts``
``[max_slots, V]`` (rebuilt from prompt + output at admission for a
penalized request, then scatter-added by every decode forward), and the
registry of grammar FSMs (:meth:`Engine.register_fsm`: each ``TokenFSM``'s
bitmask, byte DFA and token bytes uploaded once), whose per-slot states
advance by walking the sampled tokens' bytes on the device. Top-N logprobs
of the raw logits ride the same fetch as the tokens. So ``step_block(n)``
uploads one ``[max_slots, 3]`` block (tokens, FSM ids and states) before its
n forwards and fetches one packed block after them, whatever features its
slots use. :meth:`Engine.embed` pools the final-norm hidden states of a
prompt (the base model).

Multi-LoRA: ``Engine(loras={name: adapter})`` stacks the adapters
(``models/lora.py``) and a request picks one by name (``Request.lora``).
The per-slot adapter ids live on the device (``[max_slots]``, written when a
request's admission starts) and go to every prefill chunk and decode
forward, so slots with different adapters decode together. The prefix
cache's block keys chain from a seed that names the adapter: the base keeps
the plain token keys, and no adapter's blocks match the base's or another
adapter's (the KV an adapter writes is its own).

Speculative decoding: ``Engine(spec_gamma=g)`` makes every ``step()`` one
verify of all slots instead of one decode forward. A proposer drafts g
tokens a slot (``spec_proposer``; the n-gram proposer of
``engine/spec.py`` by default, or a :class:`~quant_tpu_torch.engine.spec.
DraftModelProposer`, admitted with each request); the slots' last tokens
and drafts go through one T=g+1 forward of the target, with the adapter ids,
the grammar rows walked along the drafts, the penalties, the bias and
top-logprobs, and ``sampler.spec_commit`` (or, for an all-greedy batch
without penalties or bias, the argmax chain) commits 1 to g+1 tokens a
slot. The cache lengths move to the committed length on the device, the
penalty counts take the committed tokens, and one packed block comes back
to the host. Greedy streams are the target's argmax chain, whatever the
proposer. ``step_block`` stays plain decode and ``generate`` steps singly.
A mesh raises ``NotImplementedError``.
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
    # grammar-constrained decoding: a grammar.TokenFSM (registered on the
    # device at add_request); the decode masks illegal tokens and advances
    # the slot's state on the device
    fsm: Any = None
    # OpenAI top-logprobs: the top-K raw-model logprobs of every output
    # position, fetched with the tokens (0 = off, at most 20)
    top_logprobs: int = 0
    # multi-LoRA: the name of an adapter registered with Engine(loras=...);
    # None is the base model
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
    # per-position top-K alternatives when top_logprobs > 0
    top_ids: list = dataclasses.field(default_factory=list)
    top_lps: list = dataclasses.field(default_factory=list)
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


def _fsm_mask_rows(bits: torch.Tensor, ids: torch.Tensor,
                   states: torch.Tensor, vocab: int) -> torch.Tensor:
    """Per-slot legality rows for the sampler (0 legal, -1 forbidden) from
    the packed ``[F, S, V/32]`` bitmask stack (the uint32 words held as
    int32: a shift and a mask read each bit whatever its sign)."""
    w = bits[ids, states]                               # [B, Vw]
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    exp = (w[:, :, None] >> shifts) & 1
    return torch.where(exp.reshape(w.shape[0], -1)[:, :vocab] > 0, 0,
                       -1).to(torch.int32)


def _fsm_walk(bt: torch.Tensor, tokb: torch.Tensor, tokl: torch.Tensor,
              ids: torch.Tensor, states: torch.Tensor, toks: torch.Tensor,
              eos_id: int) -> torch.Tensor:
    """Advance per-slot FSM states by walking the sampled tokens' bytes
    through the byte-DFA stack ``[F, S, 256]``: a fixed number of ``[B]``
    gathers (the registry's longest token), no host branch. EOS walks zero
    bytes (the state stays; the request is finishing)."""
    tb = tokb[ids, toks].to(torch.int64)                # [B, L]
    tl = torch.where(toks == eos_id, 0, tokl[ids, toks])
    smax = bt.shape[1] - 1
    cur = states
    for p in range(tb.shape[1]):
        nxt = bt[ids, cur.clamp(0, smax), tb[:, p]].to(cur.dtype)
        cur = torch.where(p < tl, nxt, cur)
    return cur.clamp_min(0)


def _pack(logits: torch.Tensor, toks: torch.Tensor, k_lp: int
          ) -> torch.Tensor:
    """The committed tokens ``[B(, n)]`` as the host fetches them, ``[B(,
    n), 2 + 2k]`` int32: each token, its logprob's bits and, with
    top-logprobs, k ids and k logprob bits of the raw ``logits``."""
    cols = [toks.to(torch.int32)[..., None],
            sampler.token_logprob(logits, toks).view(torch.int32)[..., None]]
    if k_lp:
        ti, tl = sampler.top_logprobs(logits, k_lp)
        cols += [ti.to(torch.int32), tl.contiguous().view(torch.int32)]
    return torch.cat(cols, -1)


@dataclasses.dataclass(frozen=True)
class _Flags:
    """What one dispatch's active slots ask of the sampler (host values)."""
    sampled: bool
    pen: bool
    bias: bool
    fsm: bool
    k_lp: int

    @property
    def adjusted(self) -> bool:
        return self.sampled or self.pen or self.bias or self.fsm


class Engine:
    """Continuous-batching engine over ``max_slots`` decode slots."""

    PREFILL_CHUNK = 512
    # registry cap (the JAX engine's)
    MAX_FSMS = 64
    # logit_bias entries a request may carry: the per-slot rows have this
    # fixed width
    MAX_LOGIT_BIAS = 300
    # slot knob columns: temperature, top_k, top_p, min_p, repetition,
    # frequency, presence
    _N_KNOBS = 7

    def __init__(self, params: llama.LlamaParams, cfg: ModelConfig,
                 max_slots: int = 8, max_seq: int = 1024, eos_id: int = 2,
                 *, device=None, max_pending: int | None = None,
                 block_admit_chunks: int | None = 4, mesh=None,
                 paged: bool = False, page_size: int | None = None,
                 n_pages: int | None = None, prefix_cache: bool = False,
                 spec_gamma: int = 0, spec_proposer=None,
                 loras: dict | None = None):
        if mesh is not None:
            raise NotImplementedError("not ported yet: mesh")
        if loras and spec_gamma and hasattr(spec_proposer, "draft_batch"):
            raise ValueError(
                "loras do not compose with a draft-MODEL proposer "
                "(the draft has no adapters, so its KV would "
                "desynchronize); n-gram speculation composes fine")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True")
        llama.check_supported(cfg)
        self.dev = resolve_device(device)
        check_on(params.final_norm, self.dev, "params")
        # multi-LoRA: adapters register at construction; requests pick one
        # by name, 0 being the base
        self.lora_names: dict = {None: 0}
        self._adapter_ids = None
        if loras:
            from quant_tpu_torch.models.lora import make_lora_stack

            params = dataclasses.replace(params, lora=make_lora_stack(
                list(loras.values()), cfg, device=self.dev))
            for j, name in enumerate(loras):
                self.lora_names[name] = j + 1
            # each slot's adapter id, on the device (stale ids of free
            # slots only feed their masked lanes)
            self._adapter_ids = torch.zeros((max_slots,), dtype=torch.int32,
                                            device=self.dev)
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
        v = cfg.vocab_size
        # per-slot token-history counts (prompt + committed output) for the
        # penalties: rebuilt at admission for a penalized request, then
        # scatter-added by every decode forward
        self.counts = torch.zeros((max_slots, v), dtype=torch.int32,
                                  device=self.dev)
        # per-slot sampling knobs (_N_KNOBS columns) and logit_bias rows,
        # written at admission; unused bias entries add 0 to token 0
        self._knobs = torch.zeros((max_slots, self._N_KNOBS),
                                  dtype=torch.float32, device=self.dev)
        self._bias_toks = torch.zeros((max_slots, self.MAX_LOGIT_BIAS),
                                      dtype=torch.int64, device=self.dev)
        self._bias_vals = torch.zeros((max_slots, self.MAX_LOGIT_BIAS),
                                      dtype=torch.float32, device=self.dev)
        # the FSM registry: [F, S, V/32] legality bits, [F, S, 256] byte
        # DFA, [F, V, L] token bytes, [F, V] token lengths; id 0 is the
        # trivial all-legal single-state FSM of unconstrained slots
        self._fsm_bits = torch.full((1, 1, -(-v // 32)), -1,
                                    dtype=torch.int32, device=self.dev)
        self._fsm_bt = torch.zeros((1, 1, 256), dtype=torch.int32,
                                   device=self.dev)
        self._fsm_tokb = torch.zeros((1, v, 1), dtype=torch.uint8,
                                     device=self.dev)
        self._fsm_tokl = torch.zeros((1, v), dtype=torch.int32,
                                     device=self.dev)
        self._fsm_key: dict[int, int] = {}
        self._fsm_objs: list = [None]
        # per-slot FSM id and state on the host, uploaded with the tokens
        self._fsm_ids = np.zeros((max_slots,), np.int64)
        self._fsm_state = np.zeros((max_slots,), np.int64)
        self._steps = 0
        self._tok_ema = 0.0
        self._last_t = time.perf_counter()
        self._ttfts: collections.deque = collections.deque(maxlen=512)
        self._tpots: collections.deque = collections.deque(maxlen=512)
        # forwards run: each prefill chunk, decode step and verify is one
        self.prefill_chunks = 0
        self.decode_forwards = 0
        self.verify_forwards = 0
        # speculative decoding: the proposer (a stateful one keeps per-slot
        # KV of the committed stream) and the acceptance counts
        self.spec_gamma = spec_gamma
        self._stateful_proposer = False
        self._spec_proposed = self._spec_accepted = 0
        self._spec_committed = self._spec_slot_steps = 0
        if spec_gamma:
            from quant_tpu_torch.engine.spec import NgramProposer

            self.proposer = spec_proposer or NgramProposer(spec_gamma)
            self._stateful_proposer = hasattr(self.proposer, "draft_batch")
            if self._stateful_proposer and self.proposer.gamma < spec_gamma:
                raise ValueError(
                    f"proposer gamma {self.proposer.gamma} < engine "
                    f"spec_gamma {spec_gamma}")

    # ── device steps ────────────────────────────────────────────────

    def _forward(self, tokens: torch.Tensor,
                 cache: llama.KVCache | llama.PagedKVCache, slot=None):
        """One forward; with adapters, under the ids of every slot, or of
        ``slot`` alone (a batch-1 prefill chunk)."""
        ids = self._adapter_ids
        if ids is not None and slot is not None:
            ids = ids[slot:slot + 1]
        return llama.forward(self.params, tokens, cache, self.cfg,
                             adapter_ids=ids, device=self.dev)

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

    def _flags(self, active) -> _Flags:
        reqs = [self.slots[i] for i in active]
        return _Flags(
            sampled=any(not r.sampling.greedy for r in reqs),
            pen=any(r.sampling.has_penalties for r in reqs),
            bias=any(bool(r.sampling.logit_bias) for r in reqs),
            fsm=any(r.fsm is not None for r in reqs),
            # the largest top_logprobs among the active slots (each request
            # keeps its own first K)
            k_lp=min(20, max((r.top_logprobs for r in reqs), default=0)))

    def _upload_slots(self, *extra: np.ndarray) -> torch.Tensor:
        """The one host-to-device copy of a dispatch: ``[max_slots, 3 +
        ...]`` (last token, FSM id, FSM state, then the ``extra`` columns:
        a verify's drafts or stream lengths)."""
        return torch.from_numpy(np.concatenate(
            [np.stack([self.last_tokens, self._fsm_ids, self._fsm_state], 1),
             *(np.asarray(x, np.int64).reshape(self.max_slots, -1)
               for x in extra)], 1)).to(self.dev)

    def _decode(self, tokens: torch.Tensor, fsm_ids: torch.Tensor,
                fsm_state: torch.Tensor, flags: _Flags, gens):
        """One forward of every slot: tokens ``[B]`` -> (next ``[B]``, the
        FSM states after it, packed ``[B, 2 + 2k]`` int32: the token, its
        logprob's bits and, with top-logprobs, k ids and k logprob bits),
        all on the device."""
        logits, self.cache = self._forward(tokens[:, None], self.cache)
        self.decode_forwards += 1
        lg = logits[:, -1]
        if flags.adjusted:
            kn = self._knobs
            nxt = sampler.sample_batch(
                lg, kn[:, 0], kn[:, 1].to(torch.int64), kn[:, 2], kn[:, 3],
                gens,
                penalties=((self.counts, kn[:, 4], kn[:, 5], kn[:, 6])
                           if flags.pen else None),
                bias=((self._bias_toks, self._bias_vals)
                      if flags.bias else None),
                fsm_rows=(_fsm_mask_rows(self._fsm_bits, fsm_ids, fsm_state,
                                         self.cfg.vocab_size)
                          if flags.fsm else None))
        else:
            nxt = lg.argmax(dim=-1)
        rows = torch.arange(nxt.shape[0], device=self.dev)
        self.counts.index_put_((rows, nxt), torch.ones_like(
            nxt, dtype=torch.int32), accumulate=True)
        if flags.fsm:
            fsm_state = _fsm_walk(self._fsm_bt, self._fsm_tokb,
                                  self._fsm_tokl, fsm_ids, fsm_state, nxt,
                                  self.eos_id)
        return nxt, fsm_state, _pack(lg, nxt, flags.k_lp)

    # ── public API ──────────────────────────────────────────────────

    def _stack_set(self, stack: torch.Tensor, fid: int, table: np.ndarray,
                   fill: int = 0) -> torch.Tensor:
        """Grow a ``[F, R, C...]`` registry stack to cover (fid, table) on
        the device and write the table's rows (the only upload)."""
        table = torch.from_numpy(np.ascontiguousarray(table)).to(self.dev)
        shape = ((max(fid + 1, stack.shape[0]),)
                 + tuple(max(t, c) for t, c in zip(table.shape,
                                                   stack.shape[1:])))
        if shape != tuple(stack.shape):
            grown = torch.full(shape, fill, dtype=stack.dtype,
                               device=self.dev)
            grown[tuple(slice(0, d) for d in stack.shape)] = stack
            stack = grown
        stack[(fid,) + tuple(slice(0, d) for d in table.shape)] = table
        return stack

    def register_fsm(self, fsm) -> int:
        """Upload a ``grammar.TokenFSM``'s tables to the device registry
        once; returns its id (idempotent per object). Its vocab and EOS must
        be the engine's."""
        key = id(fsm)
        if key in self._fsm_key:
            return self._fsm_key[key]
        if len(self._fsm_objs) - 1 >= self.MAX_FSMS:
            raise ValueError(
                f"fsm registry full ({self.MAX_FSMS}); reuse TokenFSM "
                "objects (the HTTP layer caches per pattern/schema)")
        if fsm.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"fsm vocab {fsm.vocab_size} != {self.cfg.vocab_size}")
        if fsm.eos_id != self.eos_id:
            raise ValueError(
                f"fsm eos_id {fsm.eos_id} != engine eos_id {self.eos_id}")
        fid = len(self._fsm_objs)
        self._fsm_bits = self._stack_set(self._fsm_bits, fid,
                                         fsm.bits.view(np.int32))
        self._fsm_bt = self._stack_set(self._fsm_bt, fid, fsm.byte_trans,
                                       fill=-1)
        self._fsm_tokb = self._stack_set(self._fsm_tokb, fid, fsm.tok_bytes)
        self._fsm_tokl = self._stack_set(self._fsm_tokl, fid, fsm.tok_len)
        self._fsm_key[key] = fid
        # keep the object: an id()-keyed entry must never meet another
        # TokenFSM at a reused address
        self._fsm_objs.append(fsm)
        return fid

    def add_request(self, req: Request) -> None:
        if not req.prompt or any(
                not 0 <= int(t) < self.cfg.vocab_size for t in req.prompt):
            raise ValueError(
                f"request {req.req_id}: prompt ids must be in "
                f"[0, {self.cfg.vocab_size}) and non-empty")
        if not 0 <= req.top_logprobs <= 20:
            raise ValueError("top_logprobs must be in [0, 20]")
        if req.lora is not None and req.lora not in self.lora_names:
            raise ValueError(
                f"unknown lora adapter {req.lora!r} (registered: "
                f"{[k for k in self.lora_names if k]})")
        if len(req.sampling.logit_bias) > self.MAX_LOGIT_BIAS:
            raise ValueError(f"at most {self.MAX_LOGIT_BIAS} logit_bias "
                             "entries")
        if req.fsm is not None:
            self.register_fsm(req.fsm)
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
            if self._adapter_ids is not None:
                # the prefill chunks and every later decode forward use the
                # slot's adapter
                self._adapter_ids[free] = self.lora_names[req.lora]
            if self.prefix_cache:
                # reuse the longest cached full-block prefix, then allocate
                # the slot's remaining pages up front: suffix chunks write
                # the pool's pages directly
                stream0 = req.prompt + req.output
                off0 = self._match_prefix(free, stream0, req.lora)
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
            logits, _ = self._forward(toks, view, slot)
        else:
            logits, self.pf_cache = self._forward(toks, self.pf_cache, slot)
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
            self._register_prefix(slot, stream, req.lora)
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
        seed = req.seed if req.seed is not None else req.req_id
        if req.gen_state is not None:
            gen.set_state(req.gen_state)
            req.gen_state = None
        else:
            gen.manual_seed(int(seed) & 0x7FFFFFFF)
        sc = req.sampling
        row = np.zeros((self._N_KNOBS + 2 * self.MAX_LOGIT_BIAS,),
                       np.float32)
        row[:self._N_KNOBS] = (sc.temperature, sc.top_k, sc.top_p, sc.min_p,
                               sc.repetition_penalty, sc.frequency_penalty,
                               sc.presence_penalty)
        for j, (t, v) in enumerate(sc.logit_bias):
            row[self._N_KNOBS + j] = t
            row[self._N_KNOBS + self.MAX_LOGIT_BIAS + j] = v
        row = torch.from_numpy(row).to(self.dev)
        self._knobs[slot] = row[:self._N_KNOBS]
        self._bias_toks[slot] = row[self._N_KNOBS:self._N_KNOBS
                                    + self.MAX_LOGIT_BIAS].to(torch.int64)
        self._bias_vals[slot] = row[self._N_KNOBS + self.MAX_LOGIT_BIAS:]
        fsm_row = None
        if req.fsm is not None:
            # the constraint applies to the output: replay what a preempted
            # request already produced, then mask the first sample
            fid = self.register_fsm(req.fsm)
            st = req.fsm.advance(req.fsm.start, req.output)
            self._fsm_ids[slot], self._fsm_state[slot] = fid, st
            fsm_row = _fsm_mask_rows(
                self._fsm_bits, torch.tensor([fid], device=self.dev),
                torch.tensor([st], device=self.dev), self.cfg.vocab_size)
        else:
            self._fsm_ids[slot] = self._fsm_state[slot] = 0
        if sc.has_penalties:
            # exact prompt (+ resumed output, + a cached prefix) counts; the
            # decode forwards' adds to this row while it prefilled are
            # overwritten here
            ids = torch.tensor(stream, dtype=torch.int64, device=self.dev)
            self.counts[slot].zero_()
            self.counts[slot].index_put_((ids,), torch.ones_like(
                ids, dtype=torch.int32), accumulate=True)
            tok_t = sampler.sample(last[None], sc, generator=gen,
                                   counts=self.counts[slot][None],
                                   fsm_rows=fsm_row)
            self.counts[slot, tok_t[0]] += 1
        else:
            tok_t = sampler.sample(last[None], sc, generator=gen,
                                   fsm_rows=fsm_row)
        lp = sampler.token_logprob(last[None], tok_t)
        tok = int(tok_t[0])
        if req.fsm is not None:
            self._fsm_state[slot] = req.fsm.advance(
                int(self._fsm_state[slot]), [tok])
        req.output.append(tok)
        req.logprobs.append(float(lp[0]))
        if req.top_logprobs:
            ti, tl = sampler.top_logprobs(last[None], req.top_logprobs)
            req.top_ids.append([int(t) for t in ti[0].cpu()])
            req.top_lps.append([float(v) for v in tl[0].cpu()])
        req.first_token_t = time.monotonic()
        self.slots[slot] = req
        if self.paged:
            self._tbl_dirty = True    # the slot's table row goes live
        self.last_tokens[slot] = tok
        self._maybe_finish(slot, tok)
        if req.finished:
            self._admit_finished.append(req)
        elif self._stateful_proposer:
            # the draft's KV of the committed stream but its last token
            self.proposer.admit(slot, req.prompt + req.output)
            if hasattr(self.proposer, "set_slot_key"):
                self.proposer.set_slot_key(slot, seed)
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

    def _block_keys(self, stream: list[int], lora=None) -> list[bytes]:
        """Chained digests of the stream's full page-aligned blocks:
        key_j = H(key_{j-1} || tokens of block j), so a match at block j
        certifies the whole prefix (and the KV it produced: positions are
        absolute under RoPE). The chain starts from a seed naming the
        adapter ``lora`` (empty for the base): an adapter's KV differs from
        the base's for the same tokens, so its blocks never match another
        adapter's or the base's."""
        page = self.page_size
        keys = []
        h = (b"" if lora is None else hashlib.blake2b(
            f"lora:{lora}".encode(), digest_size=16).digest())
        for j in range(len(stream) // page):
            blk = np.asarray(stream[j * page:(j + 1) * page], np.int32)
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            keys.append(h)
        return keys

    def _match_prefix(self, slot: int, stream: list[int], lora=None) -> int:
        """Point the slot's leading table entries at cached pages matching
        the stream's longest full-block prefix under adapter ``lora``;
        returns the token count covered (prefill resumes there). At least
        one token is always left to prefill: its logits seed sampling."""
        page = self.page_size
        max_k = (len(stream) - 1) // page
        k = 0
        for j, key in enumerate(self._block_keys(stream, lora)[:max_k]):
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

    def _register_prefix(self, slot: int, stream: list[int],
                         lora=None) -> None:
        """Publish the slot's filled full blocks, keyed under adapter
        ``lora``, into the prefix map (its pages now hold exactly those
        blocks' KV)."""
        for j, key in enumerate(self._block_keys(stream, lora)):
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

    def _commit(self, active, packed: np.ndarray, k_lp: int,
                finished: list[Request], n_take=None) -> int:
        """Append each active slot's tokens from the fetched ``[B, n, 2 +
        2k]`` block (slot i's first ``n_take[i]`` with ``n_take``) until it
        finishes: logprobs, top-logprobs and the host mirror of its FSM state
        with them. Returns the tokens appended."""
        toks = packed[:, :, 0]
        lps = packed[:, :, 1].view(np.float32)
        t_ids = packed[:, :, 2:2 + k_lp]
        t_lps = packed[:, :, 2 + k_lp:].view(np.float32)
        committed = 0
        for i in active:
            req = self.slots[i]
            kk = req.top_logprobs
            for j in range(toks.shape[1] if n_take is None
                           else int(n_take[i])):
                committed += 1
                tok = int(toks[i, j])
                req.output.append(tok)
                req.logprobs.append(float(lps[i, j]))
                if kk:
                    req.top_ids.append([int(t) for t in t_ids[i, j, :kk]])
                    req.top_lps.append([float(v) for v in t_lps[i, j, :kk]])
                if req.fsm is not None:
                    # replay the device's transition on the host
                    self._fsm_state[i] = req.fsm.advance(
                        int(self._fsm_state[i]), [tok])
                self.last_tokens[i] = tok
                self._maybe_finish(i, tok)
                if req.finished:
                    finished.append(req)
                    break
        return committed

    def _gens_of(self, active) -> list:
        """The generators of the active sampled slots (None elsewhere)."""
        gens = [None] * self.max_slots
        for i in active:
            if not self.slots[i].sampling.greedy:
                gens[i] = self._gens[i]
        return gens

    def _run_block(self, active, n: int, finished: list[Request]) -> None:
        """n decode forwards with tokens, counts and FSM states kept on the
        device: one upload before them, one fetch after them."""
        flags = self._flags(active)
        gens = self._gens_of(active)
        up = self._upload_slots()
        tokens, fsm_ids, fsm_state = up[:, 0], up[:, 1], up[:, 2]
        outs = []
        for _ in range(n):
            tokens, fsm_state, packed = self._decode(tokens, fsm_ids,
                                                     fsm_state, flags, gens)
            outs.append(packed)
        self._commit(active, torch.stack(outs, 1).cpu().numpy(), flags.k_lp,
                     finished)

    def _verify(self, toks: torch.Tensor, fsm_ids: torch.Tensor,
                fsm_state: torch.Tensor, flags: _Flags, gens,
                q_probs: torch.Tensor | None = None) -> torch.Tensor:
        """One T=g+1 forward of every slot over ``toks`` ``[B, g+1]`` (the
        last committed token, then the drafts) and the commit, all on the
        device: the cache lengths become base + acc + 1 and the penalty
        counts take the committed tokens. Returns the one block the host
        fetches, ``[B, (g+1)(2 + 2k) + 1]`` int32: each position's
        :func:`_pack` row, and acc last."""
        b, gp1 = toks.shape
        base = self.cache.lengths
        logits, cache = self._forward(toks, self.cache)
        self.verify_forwards += 1
        rows = None
        if flags.fsm:
            # position j's legality row: the state after walking the draft
            # prefix toks[:, 1..j] (the last committed token's transition
            # happened at its commit)
            st, rows_l = fsm_state, []
            for j in range(gp1):
                if j:
                    st = _fsm_walk(self._fsm_bt, self._fsm_tokb,
                                   self._fsm_tokl, fsm_ids, st, toks[:, j],
                                   self.eos_id)
                rows_l.append(_fsm_mask_rows(self._fsm_bits, fsm_ids, st,
                                             self.cfg.vocab_size))
            rows = torch.stack(rows_l, 1)
        if flags.sampled or flags.pen or flags.bias:
            kn = self._knobs
            out, acc = sampler.spec_commit(
                logits, toks, gens, kn[:, 0], kn[:, 1].to(torch.int64),
                kn[:, 2], kn[:, 3],
                penalties=((self.counts, kn[:, 4], kn[:, 5], kn[:, 6])
                           if flags.pen else None),
                bias=((self._bias_toks, self._bias_vals)
                      if flags.bias else None),
                q_probs=q_probs, fsm_rows=rows)
        else:
            # an all-greedy batch: the argmax chain, no filtering
            lg = logits if rows is None else sampler._fsm_mask(logits, rows)
            out = lg.argmax(dim=-1)
            acc = torch.cumprod((toks[:, 1:] == out[:, :-1]).to(torch.int64),
                                dim=1).sum(dim=1)
        # the forward advanced every length by g+1; keep the accepted prefix
        # and the commit (the tail's entries are masked by the length and
        # overwritten later)
        self.cache = dataclasses.replace(
            cache, lengths=(base + acc + 1).to(base.dtype))
        pos = torch.arange(gp1, device=self.dev)[None]
        self.counts.index_put_(
            (torch.arange(b, device=self.dev)[:, None].expand(b, gp1), out),
            (pos <= acc[:, None]).to(torch.int32), accumulate=True)
        return torch.cat([_pack(logits, out, flags.k_lp).reshape(b, -1),
                          acc.to(torch.int32)[:, None]], 1)

    def _spec_advance(self, active, finished: list[Request]) -> int:
        """One speculative step of the active slots: drafts (on the host
        for the n-gram proposer, on the device for a draft model), one
        upload, the verify, one fetch, then each slot's accepted prefix
        and commit appended, capped at ``max_seq``. Returns the tokens
        committed."""
        g = self.spec_gamma
        flags = self._flags(active)
        gens = self._gens_of(active)
        n_prop = np.zeros((self.max_slots,), np.int64)
        q_probs = None
        if self._stateful_proposer:
            lens = np.zeros((self.max_slots,), np.int64)
            for i in active:
                lens[i] = len(self.slots[i].prompt) + len(self.slots[i].output)
            up = self._upload_slots(lens)
            kn = self._knobs
            if flags.sampled and hasattr(self.proposer,
                                         "draft_batch_sampled"):
                drafts, q_probs = self.proposer.draft_batch_sampled(
                    up[:, 0], up[:, 3], kn[:, 0], kn[:, 1].to(torch.int64),
                    kn[:, 2], kn[:, 3],
                    [i for i in active if gens[i] is not None])
                q_probs = q_probs[:, :g]
            else:
                drafts = self.proposer.draft_batch(up[:, 0], up[:, 3])
            toks = torch.cat([up[:, :1], drafts[:, :g]], 1)
            n_prop[active] = g
        else:
            drafts = np.zeros((self.max_slots, g), np.int64)
            for i in active:
                req = self.slots[i]
                d = self.proposer.propose(req.prompt + req.output)[:g]
                drafts[i, :len(d)] = d
                n_prop[i] = len(d)
            up = self._upload_slots(drafts)
            toks = torch.cat([up[:, :1], up[:, 3:]], 1)
        self._spec_proposed += int(n_prop.sum())
        packed = self._verify(toks, up[:, 1], up[:, 2], flags, gens,
                              q_probs).cpu().numpy()
        acc = packed[:, -1]
        n_take = np.zeros((self.max_slots,), np.int64)
        for i in active:
            req = self.slots[i]
            # a token at stream position p needs every KV write below p;
            # writes at max_seq and past it were dropped
            n_take[i] = min(int(acc[i]) + 1,
                            self.max_seq - len(req.prompt) - len(req.output))
            # padded drafts can be "accepted" by a sampled slot: the stat
            # counts real proposals only
            self._spec_accepted += min(int(acc[i]), int(n_prop[i]))
        committed = self._commit(
            active, packed[:, :-1].reshape(self.max_slots, g + 1, -1),
            flags.k_lp, finished, n_take)
        self._spec_committed += committed
        self._spec_slot_steps += len(active)
        return committed

    def step(self) -> list[Request]:
        """One prefill chunk of admission (budgeted) + one decode forward
        for all active slots, or with ``spec_gamma`` one verify committing
        1 to ``spec_gamma + 1`` tokens a slot."""
        finished: list[Request] = []
        self._expire_deadlines(finished)
        self._advance_admission()
        spec = bool(self.spec_gamma) and any(s is not None
                                             for s in self.slots)
        self._grow_for_decode(self.spec_gamma + 1 if spec else 1)
        self._sync_paged()
        # _grow_for_decode may have preempted slots
        active = [i for i, s in enumerate(self.slots) if s is not None]
        finished += self._admit_finished
        self._admit_finished = []
        n_tok = len(active)
        if active and spec:
            n_tok = self._spec_advance(active, finished)
        elif active:
            self._run_block(active, 1, finished)
        self._steps += 1
        now = time.perf_counter()
        rate = n_tok / max(now - self._last_t, 1e-6)
        self._tok_ema = 0.9 * self._tok_ema + 0.1 * rate
        self._last_t = now
        return finished

    def step_block(self, n: int) -> list[Request]:
        """Up to n decode forwards with the tokens, penalty counts and FSM
        states kept on the device and fetched once; pending requests are
        admitted first (at most ``block_admit_chunks`` chunks while slots
        are decoding). ``n`` is capped by the longest-remaining active
        slot."""
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
        self._run_block(active, n, finished)
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
            "verify_forwards": self.verify_forwards,
            **self._pcts(self._ttfts, "ttft"),
            **self._pcts(self._tpots, "tpot"),
            **({"loras": len(self.lora_names) - 1}
               if len(self.lora_names) > 1 else {}),
            **({"fsms": len(self._fsm_objs) - 1}
               if len(self._fsm_objs) > 1 else {}),
            **({"prefix_hit_tokens": self._prefix_hit_tokens,
                "cached_blocks": len(self._prefix_map)}
               if self.prefix_cache else {}),
            **({"free_pages": len(self._free_pages),
                "total_pages": self.n_pages - 1}
               if self.paged else {}),
            **({"spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_acceptance": round(
                    self._spec_accepted / max(self._spec_proposed, 1), 3),
                # tokens a slot commits per verify (plain decode: 1.0)
                "spec_tokens_per_slot_step": round(
                    self._spec_committed / max(self._spec_slot_steps, 1), 2)}
               if self.spec_gamma else {}),
        }

    def embed(self, prompt_ids) -> np.ndarray:
        """``[dim]`` L2-normalized mean of the prompt's final-norm hidden
        states (the /v1/embeddings payload) under the base model, through a
        throwaway single-slot cache at the prompt's true length: the
        engine's slots and caches are untouched."""
        n = len(prompt_ids)
        if not 0 < n <= self.max_seq:
            raise ValueError(f"embedding input length {n} outside "
                             f"(0, {self.max_seq}]")
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in prompt_ids):
            raise ValueError(f"embedding ids must be in "
                             f"[0, {self.cfg.vocab_size})")
        cache = llama.init_cache(self.cfg, 1, n, self.dev)
        toks = torch.tensor([list(prompt_ids)], dtype=torch.int64,
                            device=self.dev)
        h, _ = llama.forward(self.params, toks, cache, self.cfg,
                             return_hidden=True, device=self.dev)
        v = h[0].mean(dim=0)
        v = v / torch.linalg.vector_norm(v).clamp_min(1e-9)
        return v.cpu().numpy()

    def has_work(self) -> bool:
        return (bool(self.pending) or self._prefilling is not None
                or any(s is not None for s in self.slots))

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 sampling: SamplingConfig = SamplingConfig(), fsm=None,
                 lora=None) -> list[list[int]]:
        """Batch API over the continuous-batching loop (``step_block(16)``
        until every request is done, or ``step()`` with ``spec_gamma``, so
        the proposer drafts before each verify), every prompt under adapter
        ``lora`` (None: the base)."""
        reqs = [Request(req_id=i, prompt=p, max_new_tokens=max_new_tokens,
                        sampling=sampling, fsm=fsm, lora=lora)
                for i, p in enumerate(prompts)]
        for r in reqs:
            self.add_request(r)
        while self.has_work():
            if self.spec_gamma:
                self.step()
            else:
                self.step_block(16)
        return [r.output for r in reqs]
