#!/usr/bin/env python
"""Text generation CLI — prompts in, completions out, through the
continuous-batching engine (serving_gen.TextEngine).

The reference has no text surface (its inputs are raw u32 ids,
rusty_vit.rs:73); this closes the loop: checkpoint + tokenizer -> strings.

Examples:
  vitrs-generate --ckpt gpt.bin --tokenizer tok.json -p "Once upon a time"
  vitrs-generate --preset gpt-nano --train-tokenizer corpus.txt \\
      -p "hello" -p "world" --max-new 32 --temperature 0.8 --top-k 50
"""

import argparse
import json
import sys
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default=None,
                   help="gpt checkpoint (else random init of --preset)")
    p.add_argument("--preset", default="gpt2-124m")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer json (data/tokenizer.py save format); "
                        "default: byte-fallback (256 + <|endoftext|>)")
    p.add_argument("--train-tokenizer", default=None, metavar="CORPUS",
                   help="train a fresh BPE on this text file first")
    p.add_argument("--vocab-size", type=int, default=512,
                   help="vocab size when training a tokenizer")
    p.add_argument("-p", "--prompt", action="append", default=[],
                   help="prompt (repeatable); default one demo prompt")
    p.add_argument("--max-new", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling cutoff (0 = off)")
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16,
                   help="decode ticks per host sync")
    p.add_argument("--echo", action="store_true", help="echo prompts")
    p.add_argument("--dtype", default=None,
                   help="float32|bfloat16 (default: bf16 on an "
                        "accelerator, fp32 on the CPU)")
    args = p.parse_args()

    import jax
    import numpy as np
    from vitrs_tpu import ViT, backend, get_config
    from vitrs_tpu.data.tokenizer import ByteBPETokenizer
    from vitrs_tpu.serving_gen import TextEngine

    if args.train_tokenizer:
        with open(args.train_tokenizer, encoding="utf-8") as f:
            tok = ByteBPETokenizer.train(f.read(), args.vocab_size)
    elif args.tokenizer:
        tok = ByteBPETokenizer.load(args.tokenizer)
    else:
        tok = ByteBPETokenizer()          # byte fallback: always works

    backend.enable_compile_cache()
    dtype = args.dtype or backend.compute_dtype()
    if args.ckpt:
        model = ViT.build_from_checkpoint(args.ckpt, dtype=dtype)
    else:
        cfg0 = get_config(args.preset, dtype=dtype)
        if tok.vocab_size > cfg0.vocab_size:   # random init: size to the
            cfg0 = cfg0.replace(vocab_size=tok.vocab_size)  # tokenizer
        model = ViT.from_config(cfg0)
    cfg = model.config
    assert cfg.mode == "gpt", "generation needs a gpt-mode model"
    assert tok.vocab_size <= cfg.vocab_size, (
        f"tokenizer vocab {tok.vocab_size} > model vocab {cfg.vocab_size}")

    prompts = args.prompt or ["Once upon a time"]
    te = TextEngine(model.params, cfg, tok, max_slots=args.slots,
                    max_len=min(args.max_len, cfg.max_seq_len),
                    decode_chunk=args.chunk, top_k=args.top_k,
                    top_p=args.top_p)
    t0 = time.perf_counter()
    outs = te.generate(prompts, max_new=args.max_new,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p, echo_prompt=args.echo)
    dt = time.perf_counter() - t0
    for text in outs:
        print(text)
    print(json.dumps({"prompts": len(prompts), "max_new": args.max_new,
                      "wall_s": round(dt, 2),
                      "tok_per_sec": round(len(prompts) * args.max_new / dt)}),
          file=sys.stderr)


if __name__ == "__main__":
    main()
