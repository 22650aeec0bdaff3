"""Muon vs AdamW at the HEADLINE geometry (gpt2-124m, T=1024, V=50257).

The round-3 Muon convergence rows lived at 4.3M/12M params; this runs both
optimizers through the production trainer at the reference's own config on
the repo-corpus task — matched steps, matched data order (same cursor
stream), 600 steps (the AdamW 1500-step curve's best-val region before the
small corpus saturates).

Usage: python benchmarks/muon_124m.py [--steps 600]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from text_pretrain_demo import build_corpus   # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--workdir", default="/tmp/vitrs_muon124m")
    args = ap.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = build_corpus(repo)
    import numpy as np
    from vitrs_tpu.data.tokenizer import ByteBPETokenizer
    os.makedirs(args.workdir, exist_ok=True)
    tag = f"v{args.vocab}_c{len(text)}"
    tok_path = os.path.join(args.workdir, f"tokenizer_{tag}.json")
    bin_path = os.path.join(args.workdir, f"tokens_{tag}.bin")
    if not (os.path.exists(tok_path) and os.path.exists(bin_path)):
        # reuse the convergence run's cached stream when present
        alt = os.path.join("/tmp/vitrs_124m_conv", f"tokens_{tag}.bin")
        if os.path.exists(alt):
            bin_path = alt
        else:
            tok = ByteBPETokenizer.train(text, args.vocab)
            tok.save(tok_path)
            np.asarray(tok.encode(text), np.uint16).tofile(bin_path)

    import jax
    from vitrs_tpu import checkpoint as C
    from vitrs_tpu import backend
    from vitrs_tpu.train.loop import TrainConfig, train, evaluate_gpt

    results = {}
    for opt_name, lr, extra in (("adamw", 3e-4, {}),
                                ("muon", 0.02, {"muon_adamw_lr": 6e-4})):
        wd = os.path.join(args.workdir, opt_name)
        tc = TrainConfig(
            preset="gpt2-124m", dataset="tokens", data_dir=bin_path,
            steps=args.steps, batch_size=args.batch, lr=lr, warmup=100,
            weight_decay=0.1,
            clip_norm=1.0 if opt_name != "muon" else 0.0,
            log_every=100, ckpt_every=args.steps, eval_every=0,
            workdir=wd, resume=True, optimizer=opt_name,
            dtype=backend.compute_dtype(),
            **extra)
        train(tc)
        ckpt = os.path.join(wd, f"ckpt_{args.steps:08d}.bin")
        params, cfg_l, _ = C.load_checkpoint(ckpt)
        res = evaluate_gpt(cfg_l, params, bin_path)
        results[opt_name] = {"val_loss": round(res["val_loss"], 4),
                             "val_ppl": round(res["ppl"], 2)}
        print(f"[{opt_name}] " + json.dumps(results[opt_name]))
    print(json.dumps({"steps": args.steps, "geometry": "gpt2-124m",
                      **results}))


if __name__ == "__main__":
    main()
