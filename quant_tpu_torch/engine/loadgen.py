"""Serving load generator: a Poisson open-loop run over the Engine.

The port of the JAX package's ``engine/loadgen.py``. Requests arrive on a
Poisson clock with prompt and output lengths drawn uniformly from the
spec's ranges (the same spec and seed give the same arrivals as the JAX
package's; ``lora`` runs every request under one adapter), and the report
holds sustained token and request throughput, mean occupancy and the
engine's TTFT / TPOT percentiles. In process, with no HTTP in the loop: it
measures the engine, not the sockets.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from quant_tpu_torch.engine.engine import Engine, Request
from quant_tpu_torch.engine.sampler import SamplingConfig

__all__ = ["LoadSpec", "run_load"]


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    n_requests: int = 64
    rate: float = 8.0            # mean arrivals per second (Poisson)
    prompt_len: tuple = (16, 64)     # uniform [lo, hi]
    max_new: tuple = (8, 32)         # uniform [lo, hi]
    sampling: SamplingConfig = SamplingConfig()
    seed: int = 0
    block: int = 0               # >0 → drive step_block(block)
    # run one request per distinct prompt-length bucket before the clock
    # starts (first calls build kernels and allocator pools); warmup
    # requests are left out of the latency reservoirs
    warmup: bool = True
    # the LoRA adapter every request runs under (None: the base model)
    lora: str | None = None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _arrivals(spec: LoadSpec, vocab: int) -> list[tuple[float, Request]]:
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.rate, spec.n_requests)
    t = np.cumsum(gaps)
    out = []
    for i in range(spec.n_requests):
        plen = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        mnew = int(rng.integers(spec.max_new[0], spec.max_new[1] + 1))
        prompt = list(map(int, rng.integers(3, vocab, plen)))
        out.append((float(t[i]),
                    Request(req_id=i, prompt=prompt, max_new_tokens=mnew,
                            sampling=spec.sampling, lora=spec.lora)))
    return out


def run_load(eng: Engine, spec: LoadSpec) -> dict:
    """Run the load to completion; returns the serving-metrics report."""
    arrivals = _arrivals(spec, eng.cfg.vocab_size)
    if spec.warmup:
        buckets = sorted({_bucket(len(r.prompt)) for _, r in arrivals})
        for j, b in enumerate(buckets):
            eng.add_request(Request(
                req_id=-1 - j, prompt=[3] * min(b, eng.max_seq - 4),
                max_new_tokens=2, sampling=spec.sampling, lora=spec.lora))
        while eng.has_work():
            eng.step_block(spec.block) if spec.block else eng.step()
        eng._ttfts.clear()
        eng._tpots.clear()
    occ_samples: list[int] = []
    finished: list[Request] = []
    i = 0
    t0 = time.monotonic()
    while i < len(arrivals) or eng.has_work():
        now = time.monotonic() - t0
        while i < len(arrivals) and arrivals[i][0] <= now:
            eng.add_request(arrivals[i][1])
            i += 1
        if eng.has_work():
            finished += (eng.step_block(spec.block) if spec.block
                         else eng.step())
            occ_samples.append(eng.stats["occupancy"])
        elif i < len(arrivals):
            time.sleep(min(0.002, max(0.0, arrivals[i][0] - now)))
    wall = time.monotonic() - t0
    toks = sum(len(r.output) for r in finished)
    st = eng.stats
    return {
        "requests": len(finished),
        "wall_s": round(wall, 3),
        "output_tokens": toks,
        "tokens_per_s": round(toks / wall, 1),
        "requests_per_s": round(len(finished) / wall, 2),
        "mean_occupancy": round(float(np.mean(occ_samples)), 2)
        if occ_samples else 0.0,
        **{k: v for k, v in st.items()
           if k.startswith(("ttft_", "tpot_"))},
    }
