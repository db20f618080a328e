"""CLI of the port: convert, generate, serve, eval, selftest, QRF1 codec.

    python -m quant_tpu_torch convert <hf_dir> <out_dir> --bits 4 \
        --group-size 128 [--device cuda]
    python -m quant_tpu_torch generate <ckpt_dir> --prompt-ids 1,2,3;4,5 \
        --max-new 32 [--slots 8] [--max-seq 1024] [--kv-bits 0|4|8|16] \
        [--device cuda]
    python -m quant_tpu_torch serve <ckpt_dir> [--host 127.0.0.1] \
        [--port 8400] [--paged [--page-size N] [--n-pages N]] \
        [--prefix-cache] [--max-pending N] [--kv-bits 0|4|8|16] \
        [--device cuda]
    python -m quant_tpu_torch eval <ckpt_dir> --text file.txt \
        [--window 512] [--limit-windows N] [--kv-bits 0|4|8|16] \
        [--device cuda]
    python -m quant_tpu_torch selftest [--device cuda]
    python -m quant_tpu_torch encode|decode <infile> <outfile> [--bits 8]
    python -m quant_tpu_torch roundtrip <infile> [--bits 8]

``convert`` turns a Hugging Face safetensors directory into a packed
checkpoint (quantized on the device, streamed tensor by tensor).
``generate`` prints one JSON line per prompt (``{"prompt": [...],
"output": [...]}``) and the engine stats on stderr. ``serve`` answers HTTP
(``engine/server.py``) until interrupted. ``eval`` prints ``{"nll", "ppl",
"tokens"}`` (with the load and eval seconds) over non-overlapping windows
of a text file (UTF-8 bytes as ids unless ``--tokenizer``). ``--kv-bits``
overrides the checkpoint's KV cache: 8 (int8), 4 (int4 packed across head
pairs) or 16 (unquantized); 0 keeps the checkpoint's. ``selftest``
checks the codec against the C++ oracle bit for bit on 1M floats, then
generates from a test-tiny model.
``encode`` / ``decode`` / ``roundtrip`` read and write the QRF1 codec file
of ``cpp/quantref_cli.cpp``. Everything runs on the card unless ``--device
cpu``. A model or option outside the ported slices (``convert --algo
gptq``, ``serve --paged`` on an MLA checkpoint, ``bench``) exits with code
2 and a "not ported" message.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import struct
import sys
import time

import numpy as np


def _load(args):
    """(params, config) of ``args.ckpt`` on ``args.device``, the config's
    KV cache replaced by ``--kv-bits`` unless it is 0."""
    from quant_tpu_torch.checkpoint import load_checkpoint

    params, cfg = load_checkpoint(args.ckpt, device=args.device)
    if args.kv_bits:
        cfg = dataclasses.replace(cfg, kv_bits=args.kv_bits)
    return params, cfg


def _cmd_generate(args) -> int:
    from quant_tpu_torch.engine import Engine, SamplingConfig

    params, cfg = _load(args)
    eng = Engine(params, cfg, max_slots=args.slots, max_seq=args.max_seq,
                 eos_id=args.eos_id, device=args.device)
    prompts = [[int(t) for t in p.split(",")]
               for p in args.prompt_ids.split(";")]
    outs = eng.generate(
        prompts, max_new_tokens=args.max_new,
        sampling=SamplingConfig(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                min_p=args.min_p))
    for p, o in zip(prompts, outs):
        print(json.dumps({"prompt": p, "output": o}))
    print(json.dumps({"stats": eng.stats}), file=sys.stderr)
    return 0


def _cmd_serve(args) -> int:
    from quant_tpu_torch.engine import Engine
    from quant_tpu_torch.engine.server import serve

    params, cfg = _load(args)
    eng = Engine(params, cfg, max_slots=args.slots, max_seq=args.max_seq,
                 eos_id=args.eos_id, device=args.device, paged=args.paged,
                 page_size=args.page_size, n_pages=args.n_pages,
                 prefix_cache=args.prefix_cache,
                 max_pending=args.max_pending)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    serve(eng, host=args.host, port=args.port,
          model_name=args.served_name or args.ckpt)
    return 0


def _cmd_convert(args) -> int:
    import torch

    from quant_tpu_torch.checkpoint import format as ckpt_format
    from quant_tpu_torch.checkpoint.hf import convert_hf_llama

    calib = np.load(args.calib) if args.calib else None
    t0 = time.perf_counter()
    cfg = convert_hf_llama(
        args.hf_dir, args.out_dir, bits=args.bits, group_size=args.group_size,
        tp=args.tp, algo=args.algo, calib_tokens=calib,
        codebook=args.codebook, device=args.device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(args.device).type == "cuda" else None)
    print(json.dumps({"converted": args.out_dir, "algo": args.algo,
                      "coder": ckpt_format.coder(),
                      "seconds": time.perf_counter() - t0,
                      "device_peak_bytes": peak, "config": cfg.__dict__}))
    return 0


def _cmd_eval(args) -> int:
    from quant_tpu_torch.eval import perplexity, tokens_from_file

    toks = tokens_from_file(args.text, args.tokenizer)
    t0 = time.perf_counter()
    params, cfg = _load(args)
    t1 = time.perf_counter()
    res = perplexity(params, cfg, toks, window=args.window,
                     limit_windows=args.limit_windows)
    t2 = time.perf_counter()
    print(json.dumps({**res, "load_s": t1 - t0, "eval_s": t2 - t1,
                      "tokens_per_s": res["tokens"] / (t2 - t1)}))
    return 0


def _cmd_bench(args) -> int:
    raise NotImplementedError("bench: the port has no bench script yet")


def _qrf1_encode(x, bits: int) -> bytes:
    """Float32 array -> QRF1 container (``cpp/quantref_cli.cpp``'s file
    format: 'QRF1' | u8 bits | f32 per-tensor scale | u64 n | QREF frame of
    the byte / nibble-packed codes), byte-compatible both ways."""
    from quant_tpu_torch.checkpoint.format import entropy_encode
    from quant_tpu_torch.core import codec

    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    codes, scale = codec.quantize(x, bits)
    payload = codec.pack_int4(codes) if bits == 4 else codes.view(np.uint8)
    return (b"QRF1" + struct.pack("<Bf", bits, float(scale))
            + struct.pack("<Q", x.size) + entropy_encode(payload))


def _qrf1_decode(blob: bytes):
    """(reconstruction, codes, scale, bits) of a QRF1 container."""
    from quant_tpu_torch.checkpoint.format import entropy_decode
    from quant_tpu_torch.core import codec

    if len(blob) < 17 or blob[:4] != b"QRF1":
        raise ValueError("not a QRF1 file")
    bits, scale = struct.unpack("<Bf", blob[4:9])
    (n,) = struct.unpack("<Q", blob[9:17])
    payload = np.frombuffer(entropy_decode(blob[17:]), np.uint8)
    codes = (codec.unpack_int4(payload, n) if bits == 4
             else payload.view(np.int8)[:n])
    return codec.dequantize(codes, np.float32(scale)), codes, scale, bits


def _read_floats(path):
    if str(path).endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(-1)
    return np.fromfile(path, np.float32)


def _cmd_encode(args) -> int:
    x = _read_floats(args.infile)
    blob = _qrf1_encode(x, args.bits)
    with open(args.outfile, "wb") as f:
        f.write(blob)
    print(json.dumps({"n": int(x.size), "bits": args.bits,
                      "bytes": len(blob),
                      "ratio": round(4.0 * x.size / len(blob), 4)}))
    return 0


def _cmd_decode(args) -> int:
    with open(args.infile, "rb") as f:
        recon, _, _, bits = _qrf1_decode(f.read())
    recon.astype(np.float32).tofile(args.outfile)
    print(json.dumps({"n": int(recon.size), "bits": int(bits)}))
    return 0


def _cmd_roundtrip(args) -> int:
    """encode -> decode in memory; prints the codes' CRC32 and the MSE
    against the uniform-quantization bound (scale/2)^2."""
    import zlib

    x = _read_floats(args.infile)
    recon, codes, scale, _ = _qrf1_decode(_qrf1_encode(x, args.bits))
    mse = float(np.mean((x - recon.astype(np.float32)) ** 2))
    ok = mse <= (scale / 2) ** 2
    print(json.dumps({
        "n": int(x.size), "bits": args.bits, "scale": float(scale),
        "codes_crc32": zlib.crc32(codes.tobytes()) & 0xFFFFFFFF,
        "mse": mse, "delta_bound": float((scale / 2) ** 2), "ok": ok}))
    return 0 if ok else 1


def _cmd_selftest(args) -> int:
    """The codec against the C++ oracle, bit for bit, on 1M floats; then a
    test-tiny generate on ``--device``."""
    from quant_tpu_torch.core import codec, oracle
    from quant_tpu_torch.engine import Engine
    from quant_tpu_torch.models import PRESETS, llama

    x = np.random.default_rng(0).standard_normal(1 << 20).astype(np.float32)
    ok = True
    if oracle.available():
        c_codes, c_scale = oracle.quantize(x, 8)
        p_codes, p_scale = codec.quantize(x, 8)
        exact = bool(np.array_equal(c_codes, p_codes)
                     and c_scale == float(p_scale))
        mse = oracle.mse(x, oracle.dequantize(c_codes, c_scale))
        delta = (c_scale / 2) ** 2
        ok = exact and mse <= delta
        print(json.dumps({"oracle": True, "codes_bit_exact": exact,
                          "mse": mse, "delta_bound": delta}))
    else:
        print(json.dumps({"oracle": False}))
    cfg = PRESETS["test-tiny"]
    eng = Engine(llama.init_params(cfg, seed=0, device=args.device), cfg,
                 max_slots=2, max_seq=32, eos_id=-1, device=args.device)
    outs = eng.generate([[1, 2, 3]], max_new_tokens=4)
    ok = ok and len(outs[0]) == 4
    print(json.dumps({"e2e_generate": len(outs[0]) == 4,
                      "device": str(args.device), "ok": ok}))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quant_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="HF safetensors dir -> packed ckpt")
    c.add_argument("hf_dir")
    c.add_argument("out_dir")
    c.add_argument("--bits", type=int, default=4)
    c.add_argument("--group-size", type=int, default=128)
    c.add_argument("--tp", type=int, default=1,
                   help="only 1 is ported")
    c.add_argument("--codebook", default=None, choices=["nf4", "lloyd"],
                   help="not ported")
    c.add_argument("--algo", choices=("rtn", "gptq", "awq", "awq+gptq"),
                   default="rtn", help="only rtn is ported")
    c.add_argument("--calib", help=".npy of [B, T] token ids (gptq/awq)")
    c.add_argument("--device", default="cuda",
                   help="where to quantize: cuda (default) or cpu")
    c.set_defaults(fn=_cmd_convert)
    g = sub.add_parser("generate", help="generate from a packed ckpt")
    g.add_argument("ckpt")
    g.add_argument("--prompt-ids", required=True,
                   help="comma-separated ids; ';' separates prompts")
    g.add_argument("--max-new", type=int, default=32)
    g.add_argument("--max-seq", type=int, default=1024)
    g.add_argument("--slots", type=int, default=8)
    g.add_argument("--eos-id", type=int, default=2)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--min-p", type=float, default=0.0)
    g.add_argument("--kv-bits", type=int, default=0, choices=(0, 4, 8, 16),
                   help="KV cache override: 0 (checkpoint's), 8 (int8), 4 "
                        "(int4, head pairs packed) or 16 (unquantized)")
    g.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    g.set_defaults(fn=_cmd_generate)
    sv = sub.add_parser("serve", help="HTTP serving frontend")
    sv.add_argument("ckpt")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8400)
    sv.add_argument("--served-name", default=None,
                    help="model id reported by /v1/models (default: the "
                         "ckpt path)")
    sv.add_argument("--slots", type=int, default=8)
    sv.add_argument("--max-seq", type=int, default=1024)
    sv.add_argument("--eos-id", type=int, default=2)
    sv.add_argument("--paged", action="store_true",
                    help="paged KV pool (memory bounded by allocated pages; "
                         "preemption when oversubscribed)")
    sv.add_argument("--page-size", type=int, default=None,
                    help="tokens per page (default: the engine's choice, "
                         "512 when max_seq allows)")
    sv.add_argument("--n-pages", type=int, default=None,
                    help="pool pages (default: full slots * max_seq "
                         "capacity)")
    sv.add_argument("--prefix-cache", action="store_true",
                    help="share the pages of full prompt blocks between "
                         "requests (requires --paged)")
    sv.add_argument("--max-pending", type=int, default=None,
                    help="admission queue cap (HTTP 429 beyond it)")
    sv.add_argument("--kv-bits", type=int, default=0,
                    choices=(0, 4, 8, 16),
                    help="KV cache override: 0 (checkpoint's), 8 (int8), 4 "
                         "(int4, head pairs packed) or 16 (unquantized)")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sv.set_defaults(fn=_cmd_serve)
    b = sub.add_parser("bench", help="not ported (exits 2)")
    b.set_defaults(fn=_cmd_bench)
    e = sub.add_parser("eval", help="perplexity on a text file")
    e.add_argument("ckpt")
    e.add_argument("--text", required=True)
    e.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer dir (needs transformers)")
    e.add_argument("--window", type=int, default=512)
    e.add_argument("--kv-bits", type=int, default=0, choices=(0, 4, 8, 16),
                   help="KV cache override: 0 (checkpoint's), 8 (int8), 4 "
                        "(int4, head pairs packed) or 16 (unquantized)")
    e.add_argument("--limit-windows", type=int, default=None)
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.set_defaults(fn=_cmd_eval)
    st = sub.add_parser("selftest", help="oracle bit-exactness + generate")
    st.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    st.set_defaults(fn=_cmd_selftest)
    en = sub.add_parser("encode", help="floats (.f32/.npy) -> QRF1 file")
    en.add_argument("infile")
    en.add_argument("outfile")
    en.add_argument("--bits", type=int, default=8, choices=(4, 8))
    en.set_defaults(fn=_cmd_encode)
    de = sub.add_parser("decode", help="QRF1 file -> raw .f32 floats")
    de.add_argument("infile")
    de.add_argument("outfile")
    de.set_defaults(fn=_cmd_decode)
    rt = sub.add_parser("roundtrip", help="encode + decode in memory; "
                                          "codes CRC32 and MSE")
    rt.add_argument("infile")
    rt.add_argument("--bits", type=int, default=8, choices=(4, 8))
    rt.set_defaults(fn=_cmd_roundtrip)
    # flags of the JAX CLI whose features are not ported (--mesh, --lora,
    # --draft-ckpt, ...) are unknown here: argparse exits naming them
    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        # a model or option outside the ported slices (paged MLA, ...)
        print(f"quant_tpu_torch: not ported: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
