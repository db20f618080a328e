"""The port's HTTP server over a CPU engine (test-tiny, float32).

One server on port 0 in front of a paged, prefix-cached engine serves every
test of the module. ``/generate`` answers the same greedy tokens as the
JAX ``Engine`` and the port's ``Engine.generate`` on the same parameters;
the NDJSON stream concatenates to the blocking answer; ``/healthz``,
``/metrics``, ``/v1/models`` and ``/v1/completions`` (token-id prompts,
JSON and SSE) answer; a full queue answers 429, invalid prompt ids 400
with the server still serving, and every field that rests on unported code
501 with the feature's name. ``python -m quant_tpu_torch serve`` starts the
same server from a checkpoint.
"""

import dataclasses
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from quant_tpu.checkpoint.format import _flatten_params
from quant_tpu.engine import Engine as JEngine
from quant_tpu.models import PRESETS as JPRESETS
from quant_tpu.models import llama as jllama
from quant_tpu_torch.engine import Engine as TEngine
from quant_tpu_torch.engine.server import serve_async
from quant_tpu_torch.models.config import ModelConfig as TConfig
from quant_tpu_torch.models.transfer import params_from_flat

REPO = pathlib.Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(JPRESETS["test-tiny"], dtype="float32")
TCFG = TConfig(**dataclasses.asdict(JCFG))
ENGINE = dict(max_slots=4, max_seq=64, eos_id=-1, paged=True, page_size=8,
              prefix_cache=True)
PROMPTS = [[100 + i for i in range(16)] + [3 + j, 5, 7] for j in range(3)]
# the server is local: never route through a proxy from the environment
_OPEN = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test processes beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jllama.init_params(JCFG, seed=0)
    jax_out = JEngine(jparams, JCFG, **ENGINE).generate(PROMPTS,
                                                        max_new_tokens=6)
    flat = jax.tree.map(np.asarray, _flatten_params(jparams))
    return params_from_flat(flat, TCFG, "cpu"), jax_out


@pytest.fixture(scope="module")
def base(params):
    eng = TEngine(params[0], TCFG, device="cpu", **ENGINE)
    httpd, srv = serve_async(eng, model_name="tiny")
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    srv.stop()


def _post(base, path, payload, timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with _OPEN(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(base, path, payload):
    """(HTTP status, decoded JSON body) of a request expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, path, payload, timeout=30)
    return e.value.code, json.loads(e.value.read())


def _get(base, path):
    with _OPEN(base + path, timeout=30) as r:
        return r.read().decode()


def test_generate_matches_engine(base, params):
    """Three concurrent requests batch in the engine; each answer equals
    the JAX engine's and the port engine's greedy tokens."""
    results = {}

    def post(i):
        results[i] = _post(base, "/generate", {
            "prompt_ids": PROMPTS[i], "max_new_tokens": 6, "logprobs": True})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    outs = [results[i]["output_ids"] for i in range(3)]
    assert outs == params[1]
    assert outs == TEngine(params[0], TCFG, device="cpu",
                           **ENGINE).generate(PROMPTS, max_new_tokens=6)
    assert all(len(results[i]["logprobs"]) == 6
               and not results[i]["timed_out"] for i in range(3))
    # stop_ids end a request at its first hit
    stopped = _post(base, "/generate", {"prompt_ids": PROMPTS[0],
                                        "max_new_tokens": 6,
                                        "stop_ids": [outs[0][1]]})
    assert stopped["output_ids"] == outs[0][:2]


def test_stream_matches_blocking(base):
    payload = {"prompt_ids": PROMPTS[1], "max_new_tokens": 8}
    blocking = _post(base, "/generate", payload)["output_ids"]
    req = urllib.request.Request(
        base + "/generate", data=json.dumps({**payload, "stream": True}
                                            ).encode(),
        headers={"Content-Type": "application/json"})
    streamed, lines, done = [], 0, None
    with _OPEN(req, timeout=120) as r:
        for raw in r:
            obj = json.loads(raw)
            if obj.get("done"):
                done = obj
                break
            streamed += obj["token_ids"]
            lines += 1
    assert streamed == blocking == done["output_ids"]
    assert len(streamed) == 8 and lines >= 2


def test_stream_disconnect_cancels(base):
    """A client that leaves mid-stream releases its slot and pages."""
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request("POST", "/generate", json.dumps(
        {"prompt_ids": PROMPTS[2], "max_new_tokens": 40, "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.readline()                    # the first chunk's size line
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    t0 = time.time()
    while time.time() - t0 < 60:
        h = json.loads(_get(base, "/healthz"))
        if h["occupancy"] == 0 and h["pending"] == 0:
            break
        time.sleep(0.05)
    assert h["occupancy"] == 0 and h["pending"] == 0
    assert h["free_pages"] + h["cached_blocks"] == h["total_pages"]


def test_health_metrics_models(base):
    h = json.loads(_get(base, "/healthz"))
    assert h["ok"] and h["total_pages"] == 4 * 8
    assert "quant_tpu_steps" in _get(base, "/metrics")
    assert "quant_tpu_requests_total" in _get(base, "/metrics")
    models = json.loads(_get(base, "/v1/models"))
    assert [m["id"] for m in models["data"]] == ["tiny"]


def test_completions_with_token_ids(base, params):
    out = _post(base, "/v1/completions", {
        "prompt": PROMPTS[0], "max_tokens": 6, "temperature": 0.0, "n": 2,
        "logprobs": True})
    assert out["object"] == "text_completion" and len(out["choices"]) == 2
    for c in out["choices"]:
        assert c["token_ids"] == params[1][0]
        assert c["finish_reason"] == "length"
        assert len(c["logprobs"]["token_logprobs"]) == 6
    assert out["usage"]["completion_tokens"] == 12
    seeded = [_post(base, "/v1/completions", {
        "prompt": PROMPTS[0], "max_tokens": 5, "seed": 7,
        "stop_token_ids": [2]})["choices"][0]["token_ids"] for _ in range(2)]
    assert seeded[0] == seeded[1]      # sampled (temperature 1), same seed
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps({
            "prompt": PROMPTS[0], "max_tokens": 6, "temperature": 0.0,
            "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with _OPEN(req, timeout=120) as r:
        for raw in r:
            if raw.startswith(b"data: "):
                events.append(raw[6:].strip())
    assert events[-1] == b"[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert sum((c["token_ids"] for c in chunks), []) == params[1][0]
    assert chunks[-1]["finish_reason"] == "length"


@pytest.mark.parametrize("path,payload,feature", [
    ("/generate", {"guided_choice": [[5]]}, "guided decoding"),
    ("/generate", {"lora": "a"}, "LoRA"),
    ("/generate", {"top_logprobs": 2}, "top-N logprobs"),
    ("/generate", {"repetition_penalty": 1.2}, "penalties"),
    ("/generate", {"logit_bias": {"5": 3.0}}, "logit_bias"),
    ("/v1/completions", {"prompt": "hello"}, "text prompts"),
    ("/v1/completions", {"logprobs": 3}, "top-N logprobs"),
    ("/v1/chat/completions", {"messages": []}, "chat completions"),
    ("/v1/embeddings", {"input": [1, 2]}, "embeddings"),
])
def test_unported_features_answer_501(base, path, payload, feature):
    body = {"prompt_ids": PROMPTS[0], "prompt": PROMPTS[0], **payload}
    code, err = _status(base, path, body)
    assert code == 501 and feature in err["error"]


def test_bad_requests_answer_400_and_server_survives(base, params):
    v = TCFG.vocab_size
    for payload in ({"prompt_ids": [1, -1]}, {"prompt_ids": [v]},
                    {"prompt_ids": []}, {}):
        assert _status(base, "/generate", payload)[0] == 400
    ok = _post(base, "/generate", {"prompt_ids": PROMPTS[0],
                                   "max_new_tokens": 6})
    assert ok["output_ids"] == params[1][0]


def test_queue_full_answers_429(params):
    eng = TEngine(params[0], TCFG, device="cpu", max_pending=0, **ENGINE)
    httpd, srv = serve_async(eng)
    try:
        code, err = _status(f"http://127.0.0.1:{httpd.server_address[1]}",
                            "/generate", {"prompt_ids": [5, 6]})
        assert code == 429 and "queue full" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def test_cli_serve_answers(tmp_path, params):
    from quant_tpu_torch.checkpoint.format import save_checkpoint

    save_checkpoint(tmp_path / "ckpt", params[0], TCFG)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "quant_tpu_torch", "serve",
         str(tmp_path / "ckpt"), "--port", str(port), "--paged",
         "--page-size", "8", "--slots", "2", "--max-seq", "64",
         "--eos-id", "-1", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.time()
        while True:
            try:
                assert json.loads(_get(base, "/healthz"))["ok"]
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.time() - t0 < 120
                time.sleep(0.2)
        out = _post(base, "/generate", {"prompt_ids": PROMPTS[0],
                                        "max_new_tokens": 6})
        assert out["output_ids"] == params[1][0]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("flag", [["--mesh", "data=2"],
                                  ["--draft-ckpt", "/x"],
                                  ["--lora", "a=/x"], ["--spec-gamma", "4"]])
def test_cli_serve_refuses_unported_flags(flag, capsys):
    from quant_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["serve", "unused-ckpt", *flag])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"unrecognized arguments: {' '.join(flag)}" in err
