"""Fixed-batch decode rates for the serving variant stack (verdict #7):
GQA kv=4 vs MHA at a LONG prompt (where the KV-cache read traffic should
matter), and streaming-window generation (ring cache, O(window) memory).

generate() prefills long prompts directly: prompt self-attention through
the fused attention op + last-only head — no (B, T0, V) logits, no
O(S·Tmax) dense scores, no chunking.  Rates are measured at batch.

Usage: python benchmarks/gen_variants.py [--mode gqa|mha|window]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import generate as G


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="gqa", choices=["gqa", "mha", "window"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=7680)
    ap.add_argument("--max-new", type=int, default=128)
    # 0 = whole-prompt prefill; N = chunked prefill (continuation chunks
    # attend through the dense cache form) — with --max-new 1 this times
    # the prefill itself
    ap.add_argument("--prefill-chunk", type=int, default=0)
    args = ap.parse_args()
    if args.mode == "window" and args.prefill_chunk:
        ap.error("--prefill-chunk does not apply to --mode window "
                 "(the streaming ring path has no chunked prefill)")

    over = {"max_seq_len": 8192}
    if args.mode == "gqa":
        over["num_kv_heads"] = 4
    if args.mode == "window":
        over = {"max_seq_len": 8192, "window": 1024, "pos_emb": "rope"}
    cfg = get_config("gpt2-124m", dtype="bfloat16", use_flash=True, **over)
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size,
                                      (args.batch, args.prompt)))
    key = jax.random.PRNGKey(1)

    if args.mode == "window":
        def fn(*a, **kw):
            return G.generate_streaming(*a, **kw)
    else:
        def fn(*a, **kw):
            return G.generate(*a, prefill_chunk=args.prefill_chunk, **kw)
    out = fn(params, prompt, cfg, args.max_new, key, temperature=0.0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(params, prompt, cfg, args.max_new, key, temperature=0.0)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    toks = args.batch * args.max_new
    print({"mode": args.mode, "tok_per_sec_incl_prefill": round(toks / dt),
           "ms_per_new_token": round(1e3 * dt / args.max_new, 2),
           "B": args.batch, "prompt": args.prompt, "max_new": args.max_new,
           "kv_heads": over.get("num_kv_heads"),
           "window": over.get("window"),
           "prefill_chunk": args.prefill_chunk})


if __name__ == "__main__":
    main()
