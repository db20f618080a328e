"""HTTP serving frontend over the continuous-batching engine.

The port of the JAX package's ``engine/server.py``: stdlib ``http.server``,
one background scheduler thread that drives ``Engine.step()``, so concurrent
requests batch together in the engine.

    POST /generate   {"prompt_ids": [...], "max_new_tokens": N,
                      "temperature": T, "top_k": K, "top_p": P,
                      "min_p": M, "timeout_s": S, "stop_ids": [...],
                      "seed": s, "logprobs": true}
        -> {"req_id": i, "output_ids": [...], "timed_out": bool
            (, "logprobs": [...])}
    POST /generate with "stream": true
        -> chunked NDJSON: one {"token_ids": [...]} line per engine step as
           tokens commit, then {"done": true, "req_id": i,
           "output_ids": [...], "timed_out": bool}. A client that
           disconnects mid-stream cancels its request.
    GET  /healthz    -> {"ok": true, ...engine stats}
    GET  /metrics    -> Prometheus text (engine stats as quant_tpu_* gauges
                        plus the server's request counters)
    GET  /v1/models  -> the served model
    POST /v1/completions  {"prompt": [ids], "max_tokens": N,
                           "temperature"/"top_k"/"top_p"/"min_p", "n": k,
                           "stop_token_ids": [...], "seed": s,
                           "logprobs": true, "stream": true -> SSE (n=1)}

``QueueFullError`` answers 429; a malformed body or invalid prompt ids
answer 400 and the server keeps serving. What rests on code the port does
not have yet answers 501 with the feature's name, never a silent default:
text prompts and ``/v1/chat/completions`` (no tokenizer), ``stop`` strings,
``guided_*``, ``lora``, ``/v1/embeddings``, top-N logprobs, sampling
penalties and ``logit_bias``.
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

__all__ = ["serve", "serve_async", "EngineServer", "NotPortedError"]


class NotPortedError(Exception):
    """A request asked for a feature whose code is not ported (HTTP 501)."""


# (body field, value that leaves the feature off, feature name)
_UNPORTED_FIELDS = (
    ("guided_regex", None, "guided decoding (guided_regex)"),
    ("guided_json", None, "guided decoding (guided_json)"),
    ("guided_choice", None, "guided decoding (guided_choice)"),
    ("lora", None, "LoRA adapters (lora)"),
    ("stop", None, "string stop sequences (stop: needs a tokenizer)"),
    ("top_logprobs", 0, "top-N logprobs (top_logprobs)"),
    ("repetition_penalty", 1.0, "sampling penalties (repetition_penalty)"),
    ("frequency_penalty", 0.0, "sampling penalties (frequency_penalty)"),
    ("presence_penalty", 0.0, "sampling penalties (presence_penalty)"),
    ("logit_bias", None, "logit_bias"),
)


def _refuse_unported(body: dict) -> None:
    """Raise :class:`NotPortedError` naming the first field of ``body`` that
    asks for an unported feature."""
    for field, off, name in _UNPORTED_FIELDS:
        v = body.get(field)
        if v is not None and v != off and v not in ({}, [], ""):
            raise NotPortedError(name)
    lp = body.get("logprobs")
    if isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
        raise NotPortedError("top-N logprobs (integer logprobs)")


def _sampling(body: dict, default_temperature: float) -> SamplingConfig:
    return SamplingConfig(
        temperature=float(body.get("temperature", default_temperature)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        min_p=float(body.get("min_p", 0.0)))


def _seed(body: dict):
    return int(body["seed"]) if body.get("seed") is not None else None


class EngineServer:
    """The engine behind a lock, driven by one scheduler thread; HTTP
    handler threads enqueue requests and wait on per-request events (or
    read per-request token queues when streaming)."""

    def __init__(self, engine: Engine, model_name: str = "quant-tpu"):
        self.engine = engine
        self.model_name = model_name
        self.lock = threading.Lock()
        self.events: dict[int, threading.Event] = {}
        # rid -> (request, tokens emitted so far, delta queue); the
        # scheduler thread is the only producer, the handler the consumer
        self.streams: dict[int, tuple[Request, int, queue.Queue]] = {}
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
                     stop_ids, seed) -> Request:
        rid = self.next_id
        self.next_id += 1
        return Request(req_id=rid, prompt=list(prompt_ids),
                       max_new_tokens=max_new_tokens, sampling=sampling,
                       deadline=self._deadline(timeout_s),
                       stop_ids=tuple(stop_ids), seed=seed)

    def submit(self, prompt_ids, max_new_tokens, sampling,
               timeout_s: float | None = None, stop_ids=(),
               seed=None) -> Request:
        """Enqueue one request and wait until it finishes."""
        return self.submit_many(prompt_ids, max_new_tokens, sampling, 1,
                                timeout_s, stop_ids, seed)[0]

    def submit_many(self, prompt_ids, max_new_tokens, sampling, n,
                    timeout_s: float | None = None, stop_ids=(),
                    seed=None) -> list[Request]:
        """Enqueue n copies of one prompt (OpenAI ``n`` choices; with an
        explicit seed, copy j gets seed + j) and wait for all of them."""
        evs, reqs = [], []
        with self.lock:
            try:
                for j in range(n):
                    req = self._new_request(
                        prompt_ids, max_new_tokens, sampling, timeout_s,
                        stop_ids, None if seed is None else int(seed) + j)
                    # register the event only once the engine took the
                    # request, so a refused submit leaks nothing
                    self.engine.add_request(req)
                    ev = threading.Event()
                    self.events[req.req_id] = ev
                    evs.append(ev)
                    reqs.append(req)
            except Exception:
                for req in reqs:      # roll back the copies enqueued
                    self.engine.cancel(req.req_id)
                    self.events.pop(req.req_id, None)
                raise
        for ev in evs:
            ev.wait()
        return reqs

    def submit_stream(self, prompt_ids, max_new_tokens, sampling,
                      timeout_s: float | None = None, stop_ids=(),
                      seed=None):
        """Enqueue a streaming request; returns (request, token queue). The
        queue yields lists of newly committed token ids, then None."""
        q: queue.Queue = queue.Queue()
        with self.lock:
            req = self._new_request(prompt_ids, max_new_tokens,
                                    sampling or SamplingConfig(), timeout_s,
                                    stop_ids, seed)
            self.engine.add_request(req)
            self.streams[req.req_id] = (req, 0, q)
        return req, q

    def cancel_stream(self, rid: int):
        with self.lock:
            self.streams.pop(rid, None)
            self.engine.cancel(rid)


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
                self._json(200, {"object": "list", "data": [
                    {"id": srv.model_name, "object": "model",
                     "owned_by": "quant-tpu"}]})
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
            sampling = _sampling(body, 0.0)
            timeout_s = body.get("timeout_s")
            if timeout_s is not None:
                timeout_s = float(timeout_s)
            stop_ids = [int(t) for t in body.get("stop_ids", [])]
            args = (body["prompt_ids"], int(body.get("max_new_tokens", 32)),
                    sampling, timeout_s, stop_ids, _seed(body))
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

        def _completions(self, body):
            prompt = body.get("prompt")
            if isinstance(prompt, str):
                raise NotPortedError("text prompts (need a tokenizer)")
            if not (isinstance(prompt, list) and prompt
                    and all(isinstance(t, int) for t in prompt)):
                raise ValueError("prompt must be a non-empty list of token "
                                 "ids (batched prompts are not supported)")
            # OpenAI defaults: temperature 1.0 (sampled)
            sampling = _sampling(body, 1.0)
            max_new = int(body.get("max_tokens", 16))
            stop_ids = [int(t) for t in body.get("stop_token_ids", [])]
            n = int(body.get("n", 1))
            if not 1 <= n <= 128:
                raise ValueError("n must be in [1, 128]")
            if body.get("stream"):
                if n != 1:
                    raise ValueError("stream requires n=1")
                self._completions_stream(srv.submit_stream(
                    prompt, max_new, sampling, None, stop_ids, _seed(body)))
                return
            reqs = srv.submit_many(prompt, max_new, sampling, n, None,
                                   stop_ids, _seed(body))
            comp = sum(len(r.output) for r in reqs)
            choices = []
            for i, r in enumerate(reqs):
                c = {"index": i, "finish_reason": self._finish_reason(r),
                     "text": "", "token_ids": r.output}
                if body.get("logprobs"):
                    c["logprobs"] = {"token_logprobs": r.logprobs,
                                     "tokens": r.output}
                choices.append(c)
            self._json(200, {
                "id": f"cmpl-{reqs[0].req_id}", "object": "text_completion",
                "created": int(time.time()), "model": srv.model_name,
                "choices": choices,
                "usage": {"prompt_tokens": len(prompt),
                          "completion_tokens": comp,
                          "total_tokens": len(prompt) + comp}})

        @staticmethod
        def _finish_reason(req):
            last = req.output[-1] if req.output else None
            if last is not None and (last == srv.engine.eos_id
                                     or last in req.stop_ids):
                return "stop"
            return "length"

        def _completions_stream(self, submitted):
            req, q = submitted
            self._start_chunked("text/event-stream")

            def sse(payload: bytes):
                self._chunk(b"data: " + payload + b"\n\n")

            try:
                while True:
                    toks = q.get()
                    done = toks is None
                    sse(json.dumps({
                        "id": f"cmpl-{req.req_id}",
                        "object": "text_completion",
                        "created": int(time.time()),
                        "model": srv.model_name,
                        "choices": [{
                            "index": 0, "text": "",
                            "token_ids": [] if done else toks,
                            "finish_reason": (self._finish_reason(req)
                                              if done else None)}]}).encode())
                    if done:
                        sse(b"[DONE]")
                        self.wfile.write(b"0\r\n\r\n")
                        return
            except OSError:
                srv.cancel_stream(req.req_id)
                log.info("SSE client gone; cancelled req=%d", req.req_id)

        def do_POST(self):
            routes = {"/generate": self._generate,
                      "/v1/completions": self._completions,
                      "/v1/chat/completions": None,
                      "/v1/embeddings": None}
            if self.path not in routes:
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                if self.path == "/v1/chat/completions":
                    raise NotPortedError("chat completions (need a "
                                         "tokenizer with a chat template)")
                if self.path == "/v1/embeddings":
                    raise NotPortedError("embeddings")
                if not isinstance(body, dict):
                    raise ValueError("the body must be a JSON object")
                _refuse_unported(body)
                routes[self.path](body)
            except NotPortedError as e:
                self._json(501, {"error": f"not ported: {e}"})
            except QueueFullError as e:
                self._json(429, {"error": str(e)})
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})

    return Handler


def _start(engine: Engine, host: str, port: int, tokenizer, model_name: str):
    if tokenizer is not None:
        raise NotImplementedError("tokenizers are not ported: serve token "
                                  "ids")
    srv = EngineServer(engine, model_name=model_name)
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
