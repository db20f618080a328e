"""HTTP serving frontend over the continuous-batching engine.

The port of the JAX package's ``engine/server.py``: stdlib ``http.server``,
one background scheduler thread that drives ``Engine.step()``, so concurrent
requests batch together in the engine.

    POST /generate   {"prompt_ids": [...], "max_new_tokens": N,
                      "temperature": T, "top_k": K, "top_p": P,
                      "min_p": M, "repetition_penalty": r,
                      "frequency_penalty": f, "presence_penalty": p,
                      "logit_bias": {"id": b}, "timeout_s": S,
                      "stop_ids": [...], "stop": "text" | [...],
                      "guided_regex" | "guided_json" | "guided_choice",
                      "seed": s, "logprobs": true, "top_logprobs": k,
                      "lora": "adapter name"}
        -> {"req_id": i, "output_ids": [...], "timed_out": bool
            (, "logprobs": [...])(, "top_token_ids", "top_logprobs")}
    POST /generate with "stream": true
        -> chunked NDJSON: one {"token_ids": [...]} line per engine step as
           tokens commit, then {"done": true, ...} with the fields above. A
           client that disconnects mid-stream cancels its request.
    GET  /healthz    -> {"ok": true, ...engine stats}
    GET  /metrics    -> Prometheus text (engine stats as quant_tpu_* gauges
                        plus the server's request counters)
    GET  /v1/models  -> the served model and its LoRA adapters (each with
                        "parent": the served model)
    POST /v1/completions  {"prompt": "text" | [ids], "max_tokens": N, the
                           sampling, penalty, bias, stop, guided and lora
                           fields, "model": name,
                           "n": k, "stop_token_ids": [...], "seed": s,
                           "logprobs": true | k, "stream": true -> SSE (n=1)}
    POST /v1/chat/completions  {"messages": [{"role", "content"}, ...]}
    POST /v1/embeddings   {"input": "text" | [ids] | [[ids] | "text", ...]}

The tokenizer is duck-typed (``encode`` / ``decode``, optionally
``apply_chat_template``); without one, token-id prompts still work and text
prompts, chat, ``stop`` strings and ``guided_regex`` / ``guided_json``
answer 400. Every choice carries ``token_ids``. ``stop`` strings are checked
on the decoded output under the scheduler lock, before stream deltas are
pushed: the answer is cut before the first match (``finish_reason``
"stop"). ``guided_*`` compile to a token FSM (``engine/grammar.py``),
cached per pattern, schema or choice list. A request runs under the LoRA
adapter its ``lora`` field names, else the one its OpenAI ``model`` field
names when that is a registered adapter, else the base model; an unknown
``lora`` answers 400. ``QueueFullError`` answers 429; a malformed body or
invalid ids answer 400 and the server keeps serving.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from quant_tpu_torch.engine.engine import Engine, QueueFullError, Request
from quant_tpu_torch.engine.sampler import SamplingConfig

log = logging.getLogger("quant_tpu_torch.server")

__all__ = ["serve", "serve_async", "EngineServer"]


def _parse_logit_bias(body: dict, vocab_size: int) -> tuple:
    """OpenAI ``logit_bias`` {"token_id": bias, ...} -> sorted tuple of
    (token_id, bias) pairs. An id outside the vocab answers 400 (a scatter
    would drop it silently); biases clamp to [-100, 100]."""
    lb = body.get("logit_bias") or {}
    pairs = []
    for t, v in lb.items():
        tid = int(t)
        if not 0 <= tid < vocab_size:
            raise ValueError(
                f"logit_bias token id {tid} outside [0, {vocab_size})")
        pairs.append((tid, min(100.0, max(-100.0, float(v)))))
    return tuple(sorted(pairs))


def _sampling(body: dict, default_temperature: float,
              vocab_size: int) -> SamplingConfig:
    return SamplingConfig(
        temperature=float(body.get("temperature", default_temperature)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        logit_bias=_parse_logit_bias(body, vocab_size))


def _seed(body: dict):
    return int(body["seed"]) if body.get("seed") is not None else None


class EngineServer:
    """The engine behind a lock, driven by one scheduler thread; HTTP
    handler threads enqueue requests and wait on per-request events (or
    read per-request token queues when streaming)."""

    def __init__(self, engine: Engine, tokenizer=None,
                 model_name: str = "quant-tpu"):
        self.engine = engine
        # duck-typed: encode / decode, optionally apply_chat_template
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.lock = threading.Lock()
        self.events: dict[int, threading.Event] = {}
        # rid -> (request, tokens emitted so far, delta queue); the
        # scheduler thread is the only producer, the handler the consumer
        self.streams: dict[int, tuple[Request, int, queue.Queue]] = {}
        # OpenAI string stops: rid -> (request, [strings]), checked on the
        # decoded output after each engine step
        self.stop_strs: dict[int, tuple[Request, list]] = {}
        # guided-decoding FSMs by (kind, pattern or choices), and the
        # tokenizer's vocabulary as bytes (built once)
        self._fsm_cache: dict = {}
        self._vocab: list[bytes] | None = None
        self.next_id = 0
        self.stop_flag = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self.stop_flag.set()
        self.thread.join(timeout=10)

    def _loop(self):
        while not self.stop_flag.is_set():
            try:
                with self.lock:
                    busy = self.engine.has_work()
                    finished = self.engine.step() if busy else []
                    finished += self._check_stop_strings()
                    self._push_stream_deltas()
                for req in finished:
                    ev = self.events.pop(req.req_id, None)
                    if ev:
                        ev.set()
            except Exception:
                # a step() exception must not kill the scheduler thread
                # (every handler would wait forever): cancel all in-flight
                # requests so clients get their partial output, then keep
                # serving
                log.exception("engine step failed; cancelling in-flight "
                              "requests")
                with self.lock:
                    for rid in list(self.events) + list(self.streams):
                        self.engine.cancel(rid)
                    for rid, (_, _, q) in list(self.streams.items()):
                        q.put(None)
                        del self.streams[rid]
                    for rid in list(self.events):
                        self.events.pop(rid).set()
                busy = False
            if not busy:
                time.sleep(0.005)

    def _check_stop_strings(self) -> list[Request]:
        """End the requests whose decoded output holds one of their stop
        strings (OpenAI ``stop``): cut the tokens at the shortest prefix
        whose text holds a match, cancel the slot, and keep the text before
        the first match (``stopped_text``) for the answer. Runs under the
        lock, before the stream deltas are pushed: a stopped token is never
        streamed."""
        finished = []
        for rid, (req, strs) in list(self.stop_strs.items()):
            if req.finished:
                del self.stop_strs[rid]
                continue
            if not req.output:
                continue
            text = self.tokenizer.decode(req.output)
            idx = min((text.find(s) for s in strs if s in text), default=-1)
            if idx < 0:
                continue
            ntok = len(req.output)
            for n in range(1, len(req.output) + 1):
                if any(s in self.tokenizer.decode(req.output[:n])
                       for s in strs):
                    ntok = n
                    break
            del req.output[ntok:]
            del req.logprobs[ntok:]
            if req.top_ids:
                del req.top_ids[ntok:]
                del req.top_lps[ntok:]
            req.stopped_text = text[:idx]
            self.engine.cancel(rid)
            req.finished = True
            del self.stop_strs[rid]
            finished.append(req)
            log.info("string stop hit req=%d at %d tokens", rid, ntok)
        return finished

    def _push_stream_deltas(self):
        """Push newly committed tokens of streaming requests into their
        queues (under the lock, after each engine step)."""
        done = []
        for rid, (req, emitted, q) in self.streams.items():
            n = len(req.output)
            if n > emitted:
                q.put(req.output[emitted:n])
                self.streams[rid] = (req, n, q)
            if req.finished:
                q.put(None)     # end of stream
                done.append(rid)
        for rid in done:
            del self.streams[rid]

    @staticmethod
    def _deadline(timeout_s):
        return time.monotonic() + timeout_s if timeout_s else None

    def _new_request(self, prompt_ids, max_new_tokens, sampling, timeout_s,
                     stop_ids, seed, fsm, top_logprobs, stop_strs,
                     lora=None) -> Request:
        """A request with the next id, its stop strings registered once the
        engine takes it (``_enqueue``)."""
        rid = self.next_id
        self.next_id += 1
        req = Request(req_id=rid, prompt=list(prompt_ids),
                      max_new_tokens=max_new_tokens, sampling=sampling,
                      deadline=self._deadline(timeout_s),
                      stop_ids=tuple(stop_ids), seed=seed, fsm=fsm,
                      top_logprobs=top_logprobs, lora=lora)
        req.stopped_text = None
        return req

    def _enqueue(self, req: Request, stop_strs) -> None:
        self.engine.add_request(req)
        if stop_strs:
            self.stop_strs[req.req_id] = (req, list(stop_strs))

    def submit(self, prompt_ids, max_new_tokens, sampling,
               timeout_s: float | None = None, stop_ids=(), seed=None,
               fsm=None, top_logprobs: int = 0, stop_strs=(),
               lora=None) -> Request:
        """Enqueue one request and wait until it finishes."""
        return self.submit_many(prompt_ids, max_new_tokens, sampling, 1,
                                timeout_s, stop_ids, seed, fsm, top_logprobs,
                                stop_strs, lora)[0]

    def submit_many(self, prompt_ids, max_new_tokens, sampling, n,
                    timeout_s: float | None = None, stop_ids=(), seed=None,
                    fsm=None, top_logprobs: int = 0,
                    stop_strs=(), lora=None) -> list[Request]:
        """Enqueue n copies of one prompt (OpenAI ``n`` choices; with an
        explicit seed, copy j gets seed + j) and wait for all of them."""
        evs, reqs = [], []
        with self.lock:
            try:
                for j in range(n):
                    req = self._new_request(
                        prompt_ids, max_new_tokens, sampling, timeout_s,
                        stop_ids, None if seed is None else int(seed) + j,
                        fsm, top_logprobs, stop_strs, lora)
                    # register the event only once the engine took the
                    # request, so a refused submit leaks nothing
                    self._enqueue(req, stop_strs)
                    ev = threading.Event()
                    self.events[req.req_id] = ev
                    evs.append(ev)
                    reqs.append(req)
            except Exception:
                for req in reqs:      # roll back the copies enqueued
                    self.engine.cancel(req.req_id)
                    self.events.pop(req.req_id, None)
                    self.stop_strs.pop(req.req_id, None)
                raise
        for ev in evs:
            ev.wait()
        return reqs

    def submit_stream(self, prompt_ids, max_new_tokens, sampling,
                      timeout_s: float | None = None, stop_ids=(),
                      seed=None, fsm=None, top_logprobs: int = 0,
                      stop_strs=(), lora=None):
        """Enqueue a streaming request; returns (request, token queue). The
        queue yields lists of newly committed token ids, then None."""
        q: queue.Queue = queue.Queue()
        with self.lock:
            req = self._new_request(prompt_ids, max_new_tokens,
                                    sampling or SamplingConfig(), timeout_s,
                                    stop_ids, seed, fsm, top_logprobs,
                                    stop_strs, lora)
            self._enqueue(req, stop_strs)
            self.streams[req.req_id] = (req, 0, q)
        return req, q

    def cancel_stream(self, rid: int):
        with self.lock:
            self.streams.pop(rid, None)
            self.stop_strs.pop(rid, None)
            self.engine.cancel(rid)

    def request_lora(self, body: dict):
        """The adapter of a request: its ``lora`` field, else the OpenAI
        ``model`` when that names a registered adapter (multi-LoRA routing
        by model name), else None (the base). An unknown ``lora`` is a
        ValueError (400)."""
        name = body.get("lora")
        if name is None:
            m = body.get("model")
            if m in self.engine.lora_names:
                name = m
            else:
                return None
        if name not in self.engine.lora_names:
            raise ValueError(f"unknown lora adapter {name!r}")
        return name

    # ── request fields that need the tokenizer ───────────────────────

    def encode(self, text: str, what: str) -> list[int]:
        if self.tokenizer is None:
            raise ValueError(f"{what} needs a server-side tokenizer (serve "
                             "--tokenizer); send token ids instead")
        return [int(t) for t in self.tokenizer.encode(text)]

    def decode(self, ids) -> str:
        return "" if self.tokenizer is None else self.tokenizer.decode(ids)

    def stop_strings(self, body: dict) -> tuple:
        """OpenAI ``stop``: a string or a list of 1-4 strings, matched on
        the decoded output (so it needs the tokenizer)."""
        s = body.get("stop")
        if s is None:
            return ()
        if isinstance(s, str):
            s = [s]
        if (not isinstance(s, list) or not s or len(s) > 4
                or not all(isinstance(x, str) and x for x in s)):
            raise ValueError("stop must be a non-empty string or a list of "
                             "1-4 non-empty strings")
        if self.tokenizer is None:
            raise ValueError("string stop sequences need a server-side "
                             "tokenizer (serve --tokenizer); use "
                             "stop_token_ids instead")
        return tuple(s)

    def guided_fsm(self, body: dict):
        """The TokenFSM of a body's ``guided_regex`` / ``guided_json`` /
        ``guided_choice`` (built once per pattern, schema or choice list);
        None when none is set."""
        from quant_tpu_torch.engine.grammar import (
            choice_fsm, json_schema_regex, regex_fsm, vocab_bytes)

        pattern = body.get("guided_regex")
        schema = body.get("guided_json")
        choice = body.get("guided_choice")
        if sum(x is not None for x in (pattern, schema, choice)) > 1:
            raise ValueError("guided_regex / guided_json / guided_choice "
                             "are mutually exclusive")
        if schema is not None:
            if not isinstance(schema, dict):
                raise ValueError("guided_json must be a schema object")
            pattern = json_schema_regex(schema)
        if pattern is None and choice is None:
            return None
        eng = self.engine
        if pattern is not None:
            if self.tokenizer is None:
                raise ValueError("guided_regex / guided_json need a "
                                 "server-side tokenizer (serve --tokenizer)")
            key = ("regex", pattern)
            if key not in self._fsm_cache:
                if self._vocab is None:
                    self._vocab = vocab_bytes(self.tokenizer,
                                              eng.cfg.vocab_size)
                self._fsm_cache[key] = regex_fsm(pattern, self._vocab,
                                                 eng.eos_id)
            return self._fsm_cache[key]
        if not isinstance(choice, list) or not choice:
            raise ValueError("guided_choice must be a non-empty list")
        seqs = []
        for c in choice:
            if isinstance(c, str):
                if self.tokenizer is None:
                    raise ValueError("string guided_choice needs a "
                                     "server-side tokenizer")
                try:
                    ids = self.tokenizer.encode(c, add_special_tokens=False)
                except TypeError:     # a duck-typed tokenizer without it
                    ids = self.tokenizer.encode(c)
                seqs.append([int(t) for t in ids])
            elif isinstance(c, list):
                seqs.append([int(t) for t in c])
            else:
                raise ValueError("guided_choice entries must be strings or "
                                 "token-id lists")
        key = ("choice", tuple(tuple(q) for q in seqs))
        if key not in self._fsm_cache:
            self._fsm_cache[key] = choice_fsm(seqs, eng.cfg.vocab_size,
                                              eng.eos_id)
        return self._fsm_cache[key]


def _make_handler(srv: EngineServer):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (the streaming paths) needs HTTP/1.1; every
        # other response sets Content-Length, so keep-alive is safe
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _start_chunked(self, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **srv.engine.stats})
            elif self.path == "/v1/models":
                models = [{"id": srv.model_name, "object": "model",
                           "owned_by": "quant-tpu"}]
                models += [{"id": n, "object": "model",
                            "owned_by": "quant-tpu",
                            "parent": srv.model_name}
                           for n in srv.engine.lora_names if n]
                self._json(200, {"object": "list", "data": models})
            elif self.path == "/metrics":
                stats = dict(srv.engine.stats, requests_total=srv.next_id,
                             streams_active=len(srv.streams))
                lines = []
                for k, v in sorted(stats.items()):
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    lines += [f"# TYPE quant_tpu_{k} gauge",
                              f"quant_tpu_{k} {v}"]
                self._send(200, ("\n".join(lines) + "\n").encode(),
                           "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "not found"})

        # ---- /generate ---------------------------------------------

        def _generate(self, body):
            sampling = _sampling(body, 0.0, srv.engine.cfg.vocab_size)
            timeout_s = body.get("timeout_s")
            if timeout_s is not None:
                timeout_s = float(timeout_s)
            stop_ids = [int(t) for t in body.get("stop_ids", [])]
            args = (body["prompt_ids"], int(body.get("max_new_tokens", 32)),
                    sampling, timeout_s, stop_ids, _seed(body),
                    srv.guided_fsm(body), int(body.get("top_logprobs", 0)),
                    srv.stop_strings(body), srv.request_lora(body))
            if body.get("stream"):
                self._stream(body, srv.submit_stream(*args))
                return
            req = srv.submit(*args)
            self._json(200, self._result(req, body))

        @staticmethod
        def _result(req, body):
            out = {"req_id": req.req_id, "output_ids": req.output,
                   "timed_out": req.timed_out}
            if body.get("logprobs"):
                out["logprobs"] = req.logprobs
            if req.top_logprobs:
                out["top_token_ids"] = req.top_ids
                out["top_logprobs"] = req.top_lps
            return out

        def _stream(self, body, submitted):
            req, q = submitted
            self._start_chunked("application/x-ndjson")
            try:
                while True:
                    toks = q.get()
                    if toks is None:
                        self._chunk(json.dumps(
                            {"done": True, **self._result(req, body)}
                        ).encode() + b"\n")
                        self.wfile.write(b"0\r\n\r\n")
                        return
                    self._chunk(json.dumps({"token_ids": toks}).encode()
                                + b"\n")
            except OSError:
                # the client is gone (reset, abort, half-close): release
                # its slot and pages
                srv.cancel_stream(req.req_id)
                log.info("stream client gone; cancelled req=%d", req.req_id)

        # ---- OpenAI-compatible layer -------------------------------

        @staticmethod
        def _prompt_ids(body):
            p = body.get("prompt")
            if isinstance(p, str):
                return srv.encode(p, "a text prompt")
            if (isinstance(p, list) and p
                    and all(isinstance(t, int) for t in p)):
                return p
            raise ValueError("prompt must be a string or a non-empty list "
                             "of token ids (batched prompts are not "
                             "supported)")

        @staticmethod
        def _top_k(body) -> int:
            """OpenAI top-K: completions' legacy integer ``logprobs`` or
            chat's ``top_logprobs`` (with ``logprobs`` true); a bool asks
            for the chosen token's logprob only."""
            lp = body.get("logprobs")
            if isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
                return min(lp, 20)
            tk = body.get("top_logprobs")
            if lp and tk:
                return min(int(tk), 20)
            return 0

        @staticmethod
        def _finish_reason(req):
            if getattr(req, "stopped_text", None) is not None:
                return "stop"
            last = req.output[-1] if req.output else None
            if last is not None and (last == srv.engine.eos_id
                                     or last in req.stop_ids):
                return "stop"
            return "length"

        @staticmethod
        def _text(req):
            # a string stop's cut leaves the stop sequence out
            cut = getattr(req, "stopped_text", None)
            return cut if cut is not None else srv.decode(req.output)

        def _choice(self, req, body, chat: bool, index: int) -> dict:
            c = {"index": index, "finish_reason": self._finish_reason(req)}
            if chat:
                c["message"] = {"role": "assistant",
                                "content": self._text(req)}
            else:
                c["text"] = self._text(req)
            c["token_ids"] = req.output
            if body.get("logprobs"):
                lp = {"token_logprobs": req.logprobs, "tokens": req.output}
                if req.top_logprobs and req.top_ids:
                    def at(ids, lps):
                        # distinct ids may decode to one string: suffix the
                        # id so every entry survives
                        d = {}
                        for t, v in zip(ids, lps):
                            key = srv.decode([t]) or str(t)
                            d[f"{key}#{t}" if key in d else key] = v
                        return d
                    lp["top_logprobs"] = [at(i, v) for i, v in
                                          zip(req.top_ids, req.top_lps)]
                    lp["top_token_ids"] = req.top_ids
                c["logprobs"] = lp
            return c

        def _oai_generate(self, body, prompt_ids, chat: bool):
            # OpenAI defaults: temperature 1.0 (sampled)
            sampling = _sampling(body, 1.0, srv.engine.cfg.vocab_size)
            max_new = int(body.get("max_tokens", 16))
            stop_ids = [int(t) for t in body.get("stop_token_ids", [])]
            n = int(body.get("n", 1))
            if not 1 <= n <= 128:
                raise ValueError("n must be in [1, 128]")
            args = (prompt_ids, max_new, sampling, None, stop_ids,
                    _seed(body))
            kw = dict(fsm=srv.guided_fsm(body), top_logprobs=self._top_k(body),
                      stop_strs=srv.stop_strings(body),
                      lora=srv.request_lora(body))
            if body.get("stream"):
                if n != 1:
                    raise ValueError("stream requires n=1")
                self._oai_stream(srv.submit_stream(*args, **kw), chat)
                return
            reqs = srv.submit_many(*args[:3], n, *args[3:], **kw)
            comp = sum(len(r.output) for r in reqs)
            self._json(200, {
                "id": f"cmpl-{reqs[0].req_id}",
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": srv.model_name,
                "choices": [self._choice(r, body, chat, i)
                            for i, r in enumerate(reqs)],
                "usage": {"prompt_tokens": len(prompt_ids),
                          "completion_tokens": comp,
                          "total_tokens": len(prompt_ids) + comp}})

        def _oai_stream(self, submitted, chat: bool):
            req, q = submitted
            self._start_chunked("text/event-stream")
            obj = "chat.completion.chunk" if chat else "text_completion"

            def sse(choice):
                self._chunk(b"data: " + json.dumps({
                    "id": f"cmpl-{req.req_id}", "object": obj,
                    "created": int(time.time()), "model": srv.model_name,
                    "choices": [choice]}).encode() + b"\n\n")

            try:
                if chat:
                    sse({"index": 0, "finish_reason": None,
                         "delta": {"role": "assistant"}, "token_ids": []})
                while True:
                    toks = q.get()
                    done = toks is None
                    toks = [] if done else toks
                    c = {"index": 0, "finish_reason":
                         self._finish_reason(req) if done else None}
                    if chat:
                        c["delta"] = ({"content": srv.decode(toks)}
                                      if toks else {})
                    else:
                        c["text"] = srv.decode(toks)
                    c["token_ids"] = toks
                    if done and req.top_logprobs:
                        c["top_token_ids"] = req.top_ids
                        c["top_logprobs"] = req.top_lps
                    sse(c)
                    if done:
                        self._chunk(b"data: [DONE]\n\n")
                        self.wfile.write(b"0\r\n\r\n")
                        return
            except OSError:
                srv.cancel_stream(req.req_id)
                log.info("SSE client gone; cancelled req=%d", req.req_id)

        def _completions(self, body):
            self._oai_generate(body, self._prompt_ids(body), chat=False)

        def _chat(self, body):
            tok = srv.tokenizer
            if tok is None or not hasattr(tok, "apply_chat_template"):
                raise ValueError("chat completions need a server-side "
                                 "tokenizer with a chat template (serve "
                                 "--tokenizer)")
            ids = tok.apply_chat_template(body["messages"],
                                          add_generation_prompt=True)
            self._oai_generate(body, [int(t) for t in ids], chat=True)

        def _embeddings(self, body):
            inp = body.get("input")
            if inp is None:
                raise ValueError("input required")
            if isinstance(inp, str) or (isinstance(inp, list) and inp
                                        and isinstance(inp[0], int)):
                inp = [inp]
            if not isinstance(inp, list) or not inp:
                raise ValueError("input must be a string, a list of token "
                                 "ids or a non-empty list of them")
            data, n_tok = [], 0
            for i, item in enumerate(inp):
                ids = (srv.encode(item, "text input") if isinstance(item, str)
                       else [int(t) for t in item])
                n_tok += len(ids)
                with srv.lock:
                    vec = srv.engine.embed(ids)
                data.append({"object": "embedding", "index": i,
                             "embedding": [float(v) for v in vec]})
            self._json(200, {"object": "list", "data": data,
                             "model": srv.model_name,
                             "usage": {"prompt_tokens": n_tok,
                                       "total_tokens": n_tok}})

        def do_POST(self):
            routes = {"/generate": self._generate,
                      "/v1/completions": self._completions,
                      "/v1/chat/completions": self._chat,
                      "/v1/embeddings": self._embeddings}
            if self.path not in routes:
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                if not isinstance(body, dict):
                    raise ValueError("the body must be a JSON object")
                routes[self.path](body)
            except QueueFullError as e:
                self._json(429, {"error": str(e)})
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})

    return Handler


def _start(engine: Engine, host: str, port: int, tokenizer, model_name: str):
    srv = EngineServer(engine, tokenizer=tokenizer, model_name=model_name)
    srv.start()
    return ThreadingHTTPServer((host, port), _make_handler(srv)), srv


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 8400,
          tokenizer=None, model_name: str = "quant-tpu"):
    """Serve until interrupted (blocking)."""
    httpd, srv = _start(engine, host, port, tokenizer, model_name)
    log.info("serving on %s:%d", host, httpd.server_address[1])
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.stop()


def serve_async(engine: Engine, host: str = "127.0.0.1", port: int = 0,
                tokenizer=None, model_name: str = "quant-tpu"):
    """Start the server in a background thread; returns (httpd,
    engine_server). ``port=0`` takes a free port
    (``httpd.server_address[1]``). Stop it with ``httpd.shutdown()`` and
    ``engine_server.stop()``."""
    httpd, srv = _start(engine, host, port, tokenizer, model_name)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, srv
