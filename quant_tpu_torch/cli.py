"""CLI of the port: ``generate`` from a packed checkpoint.

    python -m quant_tpu_torch generate <ckpt_dir> --prompt-ids 1,2,3;4,5 \
        --max-new 32 [--slots 8] [--max-seq 1024] [--device cuda]

Prints one JSON line per prompt (``{"prompt": [...], "output": [...]}``)
and the engine stats on stderr. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
