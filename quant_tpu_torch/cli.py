"""CLI of the port: ``generate`` and ``serve`` from a packed checkpoint.

    python -m quant_tpu_torch generate <ckpt_dir> --prompt-ids 1,2,3;4,5 \
        --max-new 32 [--slots 8] [--max-seq 1024] [--device cuda]
    python -m quant_tpu_torch serve <ckpt_dir> [--host 127.0.0.1] \
        [--port 8400] [--paged [--page-size N] [--n-pages N]] \
        [--prefix-cache] [--max-pending N] [--device cuda]

``generate`` prints one JSON line per prompt (``{"prompt": [...],
"output": [...]}``) and the engine stats on stderr. ``serve`` answers HTTP
(``engine/server.py``) until interrupted. Both run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _cmd_generate(args) -> int:
    from quant_tpu_torch.checkpoint import load_checkpoint
    from quant_tpu_torch.engine import Engine, SamplingConfig

    params, cfg = load_checkpoint(args.ckpt, device=args.device)
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
    from quant_tpu_torch.checkpoint import load_checkpoint
    from quant_tpu_torch.engine import Engine
    from quant_tpu_torch.engine.server import serve

    params, cfg = load_checkpoint(args.ckpt, device=args.device)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quant_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
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
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sv.set_defaults(fn=_cmd_serve)
    # flags of the JAX CLI whose features are not ported (--mesh, --lora,
    # --kv-bits, ...) are unknown here: argparse exits naming them
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
