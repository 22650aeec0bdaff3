"""Continuous-batching serving throughput (GPT-2 124M, one GPU).

Submits a Poisson-ish mix of prompt lengths and measures aggregate
generated tok/s through serving_gen.GenerationEngine — the serving number
that matters for a text endpoint (vs the fixed-batch `generate()` bench).

Usage: python benchmarks/serving_engine.py [--slots 8] [--requests 32]
       [--max-new 64] [--paged]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 params")
    ap.add_argument("--chunk", type=int, default=16,
                    help="decode ticks per host sync (1 = per-token)")
    ap.add_argument("--preset", default="gpt2-124m",
                    help="e.g. gpt2-moe-8e for the MoE decode row")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="GQA decode (0 = config default)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="fixed prompt length (0 = mixed 16..128) — long "
                         "prompts quantify the GQA KV-cache-traffic win")
    ap.add_argument("--seq", type=int, default=0,
                    help="override max_seq_len (long-context serving)")
    args = ap.parse_args()

    import jax
    import numpy as np
    from vitrs_tpu import params as PRM
    from vitrs_tpu.config import get_config
    from vitrs_tpu.serving_gen import GenerationEngine

    over = {}
    if args.kv_heads:
        over["num_kv_heads"] = args.kv_heads
    if args.window:
        over["window"] = args.window
    if args.seq:
        over["max_seq_len"] = args.seq
    cfg = get_config(args.preset, dtype="bfloat16", use_flash=True, **over)
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    if args.int8:
        from vitrs_tpu.ops import quant
        params = quant.quantize_params(params, mode="gpt")

    rng = np.random.default_rng(0)
    if args.prompt_len:
        lengths = np.full(args.requests, args.prompt_len)
    else:
        lengths = rng.integers(16, 128, args.requests)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    eng = GenerationEngine(params, cfg, max_slots=args.slots,
                           max_len=args.max_len, paged=args.paged,
                           decode_chunk=args.chunk, top_k=0)
    # warmup: run the full request mix once so every (bucket, group-size)
    # prefill program and the decode scan are compiled before timing —
    # a server compiles each shape once in its lifetime; steady-state
    # throughput is the number that matters
    for p in prompts:
        eng.submit(p, max_new=2)
    eng.run()

    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new=args.max_new)
    outs = eng.run()
    dt = time.perf_counter() - t0
    gen_toks = sum(len(o) - len(p) for (_, o), p in zip(outs, prompts))
    print({"engine_tok_per_sec": round(gen_toks / dt),
           "ms_per_tok_slotstep": round(1e3 * dt / max(gen_toks // min(
               args.slots, args.requests), 1), 2),
           "preset": args.preset, "kv_heads": args.kv_heads or None,
           "window": args.window or None, "prompt_len": args.prompt_len
           or None, "requests": args.requests, "slots": args.slots,
           "paged": args.paged, "int8": args.int8, "chunk": args.chunk,
           "wall_s": round(dt, 2)})


if __name__ == "__main__":
    main()
