"""End-to-end TEXT pretraining demo: corpus -> byte-BPE tokenizer -> GPT
pretraining -> held-out perplexity -> text generation.

The reference's input modality stops at raw token ids (rusty_vit.rs:73);
this drives the full text loop the framework added on top: train a
tokenizer on a local corpus (default: this repo's own source/docs — the
only guaranteed text in a zero-egress container), encode to the llm.c-style
uint16 stream, pretrain a small GPT with the standard loop (cosine LR,
clip, checkpoints), report train/val loss + val perplexity, and sample
completions through TextEngine.

Usage:
  python benchmarks/text_pretrain_demo.py [--corpus FILE] [--steps 800]
      [--vocab 1024] [--workdir /tmp/vitrs_text]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_corpus(repo_root: str) -> str:
    parts = []
    for pat in ("*.md", "*.py", "vitrs_tpu/*.py", "vitrs_tpu/*/*.py",
                "tests/*.py"):
        for f in sorted(glob.glob(os.path.join(repo_root, pat))):
            with open(f, encoding="utf-8", errors="replace") as fh:
                parts.append(fh.read())
    return "\n".join(parts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=None, help="text file (default: "
                    "this repo's own source + docs)")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--channels", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--workdir", default="/tmp/vitrs_text_demo")
    ap.add_argument("--prompt", action="append", default=[])
    ap.add_argument("--num-experts", type=int, default=0,
                    help="MoE experts per layer (0 = dense MLP) — the "
                         "quality-per-step comparison vs dense at matched "
                         "token budget (ops/moe.py; ~E/2x the MLP params "
                         "at ~2x the per-token MLP FLOPs for top-2)")
    ap.add_argument("--moe-top-k", type=int, default=2)
    ap.add_argument("--no-generate", action="store_true")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = (open(args.corpus, encoding="utf-8", errors="replace").read()
            if args.corpus else build_corpus(repo))
    print(f"corpus: {len(text):,} chars")

    import numpy as np
    from vitrs_tpu.data.tokenizer import ByteBPETokenizer

    os.makedirs(args.workdir, exist_ok=True)
    # cache key carries the vocab + corpus identity so a rerun with
    # different flags never silently reuses a stale tokenizer/stream
    tag = f"v{args.vocab}_c{len(text)}"
    tok_path = os.path.join(args.workdir, f"tokenizer_{tag}.json")
    bin_path = os.path.join(args.workdir, f"tokens_{tag}.bin")
    if os.path.exists(tok_path) and os.path.exists(bin_path):
        tok = ByteBPETokenizer.load(tok_path)
        print("reusing tokenizer + token bin from workdir")
    else:
        tok = ByteBPETokenizer.train(text, args.vocab)
        tok.save(tok_path)
        ids = np.asarray(tok.encode(text), np.uint16)
        ids.tofile(bin_path)
        print(f"tokenized: {len(ids):,} tokens "
              f"({len(text) / len(ids):.2f} chars/token)")

    from vitrs_tpu.train.loop import TrainConfig, train, evaluate_gpt

    overrides = dict(max_seq_len=args.seq, vocab_size=tok.vocab_size,
                     num_layers=args.layers, channels=args.channels,
                     num_heads=args.heads)
    if args.num_experts:
        overrides.update(num_experts=args.num_experts,
                         moe_top_k=args.moe_top_k)
    tc = TrainConfig(preset="gpt-nano", dataset="tokens",
                     data_dir=bin_path, steps=args.steps,
                     batch_size=args.batch, lr=args.lr, warmup=100,
                     weight_decay=0.1, clip_norm=1.0, log_every=50,
                     ckpt_every=args.steps, eval_every=0,
                     workdir=args.workdir, model_overrides=overrides)
    train(tc)

    from vitrs_tpu import checkpoint as C
    ckpt = os.path.join(args.workdir, f"ckpt_{args.steps:08d}.bin")
    params, cfg_l, _ = C.load_checkpoint(ckpt)
    res = evaluate_gpt(cfg_l, params, bin_path)
    print(json.dumps({"val_loss": round(res["val_loss"], 4),
                      "val_ppl": round(res["ppl"], 2),
                      "random_ppl": tok.vocab_size}))

    # strings in -> strings out through the serving engine
    import jax
    from vitrs_tpu.serving_gen import TextEngine
    dparams = {k: jax.device_put(v) for k, v in params.items()}
    te = TextEngine(dparams, cfg_l, tok, max_slots=4,
                    max_len=min(256, cfg_l.max_seq_len), decode_chunk=16)
    if args.no_generate:
        return
    prompts = args.prompt or ["def forward(", "# model", "import jax"]
    outs = te.generate(prompts, max_new=48, temperature=0.0,
                       echo_prompt=True)
    for t in outs:
        print("---\n" + t)


if __name__ == "__main__":
    main()
