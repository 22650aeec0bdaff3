"""Speculative-decoding latency bench on repo-corpus models.

Trains (or reuses from the workdir) the text-demo target (12M, L6/C384) and
a cheap draft (L2/C128) on the SAME corpus/tokenizer, then measures B=1
greedy decode: plain KV-cache generate() vs generate_speculative() at
several K, reporting tok/s and the acceptance rate.  Real trained models
matter here — random weights never agree, so acceptance (the whole game)
would be ~1/vocab.

Usage: python benchmarks/speculative_demo.py [--max-new 192] [--ks 2,4,6]
       (expects/creates the text_pretrain_demo workdir)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from text_pretrain_demo import build_corpus  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/vitrs_text_demo")
    ap.add_argument("--steps", type=int, default=1500,
                    help="target training steps (skipped if ckpt exists)")
    ap.add_argument("--draft-steps", type=int, default=1000)
    ap.add_argument("--max-new", type=int, default=192)
    ap.add_argument("--ks", default="2,4,6")
    ap.add_argument("--prompt", default="def forward(")
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from vitrs_tpu.data.tokenizer import ByteBPETokenizer
    from vitrs_tpu.train.loop import TrainConfig, train
    from vitrs_tpu import checkpoint as C
    from vitrs_tpu.models import generate as G
    from vitrs_tpu.models import speculative as SP

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = build_corpus(repo)
    tag = f"v1024_c{len(text)}"
    tok_path = os.path.join(args.workdir, f"tokenizer_{tag}.json")
    bin_path = os.path.join(args.workdir, f"tokens_{tag}.bin")
    os.makedirs(args.workdir, exist_ok=True)
    if not (os.path.exists(tok_path) and os.path.exists(bin_path)):
        tok = ByteBPETokenizer.train(text, 1024)
        tok.save(tok_path)
        np.asarray(tok.encode(text), np.uint16).tofile(bin_path)
    tok = ByteBPETokenizer.load(tok_path)

    def ensure(workdir, steps, overrides):
        ckpt = os.path.join(workdir, f"ckpt_{steps:08d}.bin")
        if not os.path.exists(ckpt):
            train(TrainConfig(preset="gpt-nano", dataset="tokens",
                              data_dir=bin_path, steps=steps, batch_size=32,
                              lr=6e-4, warmup=100, weight_decay=0.1,
                              clip_norm=1.0, log_every=200, ckpt_every=steps,
                              eval_every=0, workdir=workdir,
                              model_overrides=overrides))
        return C.load_checkpoint(ckpt)

    base = dict(max_seq_len=256, vocab_size=tok.vocab_size)
    t_params, t_cfg, _ = ensure(args.workdir, args.steps,
                                dict(base, num_layers=6, channels=384,
                                     num_heads=6))
    d_params, d_cfg, _ = ensure(os.path.join(args.workdir, "draft"),
                                args.draft_steps,
                                dict(base, num_layers=2, channels=128,
                                     num_heads=2))

    prompt = jnp.asarray(tok.encode(args.prompt), jnp.int32)[None]
    N = args.max_new

    def timeit(f):
        out = f()
        tok_sync = np.asarray(out[0] if isinstance(out, tuple) else out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = f()
            np.asarray(out[0] if isinstance(out, tuple) else out)
        return (time.perf_counter() - t0) / reps, out

    dt_plain, plain = timeit(lambda: G.generate(
        t_params, prompt, t_cfg, max_new=N, key=jax.random.PRNGKey(0),
        temperature=0.0))
    rows = [{"mode": "plain", "tok_per_sec": round(N / dt_plain, 1),
             "ms_per_token": round(1e3 * dt_plain / N, 2)}]

    for K in [int(k) for k in args.ks.split(",")]:
        dt, (out, stats) = timeit(lambda K=K: SP.generate_speculative(
            t_params, d_params, prompt, t_cfg, d_cfg, max_new=N, K=K,
            key=jax.random.PRNGKey(0), temperature=0.0))
        a, b = np.asarray(out), np.asarray(plain)
        neq = np.nonzero(a[0] != b[0])[0]
        diverge = int(neq[0]) if neq.size else a.shape[1]
        if jax.default_backend() == "cpu":
            # deterministic same-order math: spec greedy IS target greedy
            assert neq.size == 0, ("speculative greedy must be bitwise "
                                   f"target-greedy on cpu; diverged at "
                                   f"{diverge}")
        else:
            # on the GPU the batched verify forward and the stepwise decode are
            # different XLA programs whose bf16 logits differ in low bits;
            # one argmax near-tie flip diverges the suffix permanently.
            # Require agreement well past the prompt, report the rest.
            assert diverge >= min(32, a.shape[1]), (
                f"speculative/plain diverged at token {diverge}")
        rate = float(stats["accepted"]) / max(1.0, float(stats["drafted"]))
        rows.append({"mode": f"spec K={K}",
                     "tok_per_sec": round(N / dt, 1),
                     "ms_per_token": round(1e3 * dt / N, 2),
                     "accept_rate": round(rate, 3),
                     "target_calls": int(stats["target_calls"]),
                     "match_prefix": diverge,
                     "speedup": round(dt_plain / dt, 2)})
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
