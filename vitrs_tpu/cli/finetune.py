#!/usr/bin/env python
"""LoRA finetuning CLI — adapt a pretrained GPT checkpoint to a token
corpus with rank-r adapters (models/lora.py): base weights frozen,
optimizer state ~100x smaller than full finetuning, output is either a
tiny adapter file or a merged standalone checkpoint.

The reference can only full-finetune (its optimizer walks the whole arena,
train_vit.rs:619-668); this is the parameter-efficient path.

Examples:
  vitrs-finetune --ckpt gpt2-124m.bin --dataset tokens --data-dir ids.bin \\
      --steps 500 --rank 8 --out adapters.npz
  vitrs-finetune --ckpt base.bin --data-dir ids.bin --merge merged.bin
"""

import argparse
import json
import os
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="base gpt checkpoint (.bin)")
    p.add_argument("--data-dir", default=None,
                   help="uint16 token file (tokens dataset); default: "
                        "synthetic stream")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--out", default="lora_adapters.npz",
                   help="adapter tree output path")
    p.add_argument("--resume", default=None,
                   help="adapter tree to continue training from")
    p.add_argument("--merge", default=None, metavar="MERGED_BIN",
                   help="also bake adapters into a standalone checkpoint")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from vitrs_tpu import backend
    backend.enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from vitrs_tpu import checkpoint as C
    from vitrs_tpu import checkpoint_tree as CT
    from vitrs_tpu.data import tokens as TOK
    from vitrs_tpu.models import lora as LO
    from vitrs_tpu.ops import optimizer as opt
    from vitrs_tpu.train.loop import evaluate_gpt

    np_params, cfg, _ = C.load_checkpoint(args.ckpt)
    assert cfg.mode == "gpt", "vitrs-finetune targets gpt checkpoints"
    params = {k: jax.device_put(jnp.asarray(v)) for k, v in np_params.items()}
    print(f"base: {args.ckpt} ({cfg.num_layers}L/{cfg.channels}C, "
          f"vocab {cfg.vocab_size})")

    if args.resume and os.path.exists(args.resume):
        host, meta = CT.load_tree(args.resume)
        lora = jax.tree.map(jnp.asarray, host)
        print(f"[resume] adapters from {args.resume} (rank {meta['rank']})")
    else:
        lora = LO.init_lora(cfg, jax.random.PRNGKey(args.seed),
                            rank=args.rank)
    m, v = LO.init_lora_opt(lora)
    n_adapter = sum(int(np.prod(t.shape)) for t in lora.values())
    n_base = sum(int(np.prod(t.shape)) for t in params.values())
    print(f"adapters: {n_adapter:,} trainable params "
          f"({100.0 * n_adapter / n_base:.2f}% of base)")

    stream = TOK.get_tokens(args.data_dir, cfg.vocab_size, seed=args.seed)
    total_w = (len(stream) - 1) // cfg.max_seq_len
    holdout = TOK.default_holdout(total_w)
    loader = TOK.TokenLoader(stream, args.batch_size, cfg.max_seq_len,
                             holdout=holdout)

    t0 = time.time()
    for s in range(args.steps):
        lr = opt.cosine_lr_host(s, args.lr, args.warmup, args.steps)
        xb, yb = loader.next_batch()
        loss, lora, m, v = LO.lora_train_step(
            lora, m, v, jnp.asarray(s), params,
            jnp.asarray(xb), jnp.asarray(yb), cfg, lr=float(lr),
            alpha=args.alpha, weight_decay=args.weight_decay)
        if s % args.log_every == 0 or s == args.steps - 1:
            print(json.dumps({"step": s, "loss": round(float(loss), 5),
                              "lr": round(float(lr), 7)}))

    CT.save_tree(args.out, jax.device_get(lora),
                 meta={"rank": args.rank, "alpha": args.alpha,
                       "base": os.path.basename(args.ckpt),
                       "steps": args.steps})
    print(f"[saved] adapters -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.2f} MB vs base "
          f"{os.path.getsize(args.ckpt) / 1e6:.1f} MB)")

    merged = LO.merge_lora(params, lora, alpha=args.alpha)
    res = evaluate_gpt(cfg, jax.device_get(merged), args.data_dir,
                       seed=args.seed)
    print(json.dumps({"val_loss": round(res["val_loss"], 4),
                      "val_ppl": round(res["ppl"], 2),
                      "wall_s": round(time.time() - t0, 1)}))
    if args.merge:
        C.save_checkpoint(args.merge, jax.device_get(merged), cfg)
        print(f"[saved] merged checkpoint -> {args.merge}")


if __name__ == "__main__":
    main()
