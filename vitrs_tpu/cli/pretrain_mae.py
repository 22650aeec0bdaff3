#!/usr/bin/env python
"""MAE pretraining CLI (BASELINE.json configs[4]): masked-patch pretrain, then
export the encoder in the reference-compatible checkpoint format so
`train.py` / `ViT.build_from_checkpoint` can fine-tune it directly.

Example:
  python pretrain_mae.py --preset vit-tiny-4-cifar10 --steps 1000
  python train.py --preset vit-tiny-4-cifar10 \\
      --workdir /tmp/finetune --init-ckpt /tmp/vitrs_mae/encoder_final.bin
"""

import argparse
import json
import os
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="vit-tiny-4-cifar10")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1.5e-4)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--mask-ratio", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--workdir", default="/tmp/vitrs_mae")
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from vitrs_tpu import backend
    from vitrs_tpu import checkpoint as C
    from vitrs_tpu import checkpoint_tree as CT

    backend.enable_compile_cache()
    from vitrs_tpu.config import get_config
    from vitrs_tpu.data import datasets as D
    from vitrs_tpu.data.prefetch import DevicePrefetcher
    from vitrs_tpu.models import mae as MAE
    from vitrs_tpu.ops import optimizer as opt

    os.makedirs(args.workdir, exist_ok=True)
    cfg = get_config(args.preset, dtype=args.dtype)
    params = MAE.init_mae_params(cfg, jax.random.PRNGKey(args.seed))
    zeros = lambda: jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.shape, jnp.float32), params)
    m, v = zeros(), zeros()

    ds = D.get_dataset(args.dataset, args.data_dir, train=True)
    loader = D.DataLoader(ds, args.batch_size, seed=args.seed, train=True)
    prefetch = DevicePrefetcher(loader)

    def step_fn(p, m, v, x, i, lr, seed):
        rng = jax.random.PRNGKey(seed)   # built inside jit: no eager dispatch
        loss, g = jax.value_and_grad(MAE.mae_loss)(p, x, cfg, rng,
                                                   args.mask_ratio)
        p, m, v = opt.adamw_tree(p, g, m, v, i, lr,
                                 weight_decay=args.weight_decay)
        return p, m, v, loss

    jstep = jax.jit(step_fn, donate_argnums=(0, 1, 2))
    t_last, since = time.perf_counter(), 0
    try:
        for step in range(1, args.steps + 1):
            x, _ = next(prefetch)
            lr = opt.cosine_lr_host(step, args.lr, args.warmup, args.steps)
            params, m, v, loss = jstep(params, m, v, x,
                                       np.int32(step), np.float32(lr),
                                       np.uint32((args.seed * 100003 + step)
                                                 % (1 << 32)))
            since += args.batch_size
            if step % args.log_every == 0 or step == args.steps:
                lv = float(loss)
                now = time.perf_counter()
                rec = {"step": step, "mae_loss": round(lv, 5),
                       "imgs_per_sec": round(since / (now - t_last), 1)}
                print("[mae] " + json.dumps(rec))
                t_last, since = now, 0
    finally:
        prefetch.close()

    # full MAE state (encoder + decoder)
    CT.save_tree(os.path.join(args.workdir, "mae_final.tree"),
                 jax.device_get(params),
                 meta={"mask_ratio": args.mask_ratio, "steps": args.steps})
    # encoder alone, reference-compatible format — fine-tunable by train.py
    enc_path = os.path.join(args.workdir, "encoder_final.bin")
    C.save_checkpoint(enc_path, jax.device_get(params["encoder"]), cfg,
                      step=args.steps, seed=args.seed)
    print(f"[done] encoder -> {enc_path}")


if __name__ == "__main__":
    main()
