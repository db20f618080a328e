"""Perplexity of a token stream under a model.

The port of the JAX package's ``eval/perplexity.py``: non-overlapping
windows, each run as one prefill over a fresh cache, teacher-forced
next-token NLL in float32. It runs where the params lie (the card unless
they were loaded onto the CPU), through ``llama.forward``'s projections
(``dequant_matmul``, the CUDA kernel on the card unless
``cfg.kernel_mode`` is "xla").
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quant_tpu_torch.models import llama
from quant_tpu_torch.models.config import ModelConfig

__all__ = ["perplexity", "tokens_from_file"]


def _window_nll(params: llama.LlamaParams, cfg: ModelConfig,
               win: np.ndarray) -> tuple[float, int]:
    """(summed NLL, count) of one ``[window + 1]`` slice: the first
    ``window`` tokens are the input, the last ``window`` the targets."""
    dev = params.device
    win = torch.as_tensor(np.asarray(win, np.int64), device=dev)[None]
    cache = llama.init_cache(cfg, 1, win.shape[1] - 1, device=dev)
    logits, _ = llama.forward(params, win[:, :-1], cache, cfg, device=dev)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = win[:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return float(nll.sum()), tgt.numel()


def perplexity(params: llama.LlamaParams, cfg: ModelConfig,
               tokens: np.ndarray, window: int = 512,
               limit_windows: int | None = None) -> dict:
    """Mean NLL and perplexity of ``tokens`` under the model. Windows are
    non-overlapping; the first token of each is context only. Returns
    ``{"nll", "ppl", "tokens"}``."""
    toks = np.asarray(tokens, np.int64).reshape(-1)
    n_win = (toks.size - 1) // window
    if limit_windows is not None:
        n_win = min(n_win, limit_windows)
    if n_win < 1:
        raise ValueError(f"need > {window} tokens, got {toks.size}")
    total, count = 0.0, 0
    with torch.inference_mode():
        for i in range(n_win):
            s, c = _window_nll(params, cfg,
                              toks[i * window: i * window + window + 1])
            total += s
            count += c
    nll = total / count
    return {"nll": nll, "ppl": math.exp(nll), "tokens": count}


def tokens_from_file(path: str, tokenizer_dir: str | None = None
                     ) -> np.ndarray:
    """Token ids of a text file: a local HF tokenizer's (``tokenizer_dir``;
    needs the ``transformers`` package), else the UTF-8 bytes."""
    text = open(path, "r", encoding="utf-8", errors="replace").read()
    if tokenizer_dir:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise NotImplementedError(
                "--tokenizer needs the transformers package, which this "
                "machine lacks; leave it out for byte-level ids") from e
        tok = AutoTokenizer.from_pretrained(tokenizer_dir)
        return np.asarray(tok(text)["input_ids"], np.int32)
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.int32)
