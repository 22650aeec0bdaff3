"""ViT training throughput on one GPU, parameterized by preset.

The ViT-family counterpart of gpt2_train.py: full fused train step
(fwd + bwd + tree-form AdamW), remat selectable to measure the
selective-checkpoint gap (VERDICT r2 weak #1: blanket remat cost 24% on
ViT-L; the selective policy should cut that to <=10%).

Usage: python benchmarks/vit_train.py [--preset vit-l-16] [--batch 32]
       [--remat | --remat-full] [--iters 20]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from vitrs_tpu import backend
from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.utils import flops as F


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="vit-l-16")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--remat", action="store_true",
                    help="selective policy (save attention out + LN stats)")
    ap.add_argument("--remat-full", action="store_true",
                    help="blanket jax.checkpoint (the round-2 comparison)")
    args = ap.parse_args()

    remat = "full" if args.remat_full else bool(args.remat)
    dev = jax.devices()[0]
    cfg = get_config(args.preset).replace(dtype=backend.compute_dtype(),
                                          remat=remat)
    B = args.batch

    key = jax.random.PRNGKey(0)
    params = PRM.init_params(cfg, key)
    zeros = lambda: jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    m, v = zeros(), zeros()
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(
        (B, cfg.img_size, cfg.img_size, cfg.in_chans), dtype=np.float32))
    y = jnp.asarray(rng.integers(0, cfg.num_classes, (B,)))

    def train_step(p, m, v, x, y, step, lr):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        p, m, v = opt.adamw_tree(p, grads, m, v, step, lr, weight_decay=0.05)
        return p, m, v, loss

    step_fn = jax.jit(train_step, donate_argnums=(0, 1, 2))
    s = lambda i: (jnp.asarray(i, jnp.int32), jnp.asarray(1e-3, jnp.float32))

    params, m, v, loss = step_fn(params, m, v, x, y, *s(1))
    float(loss)

    t0 = time.perf_counter()
    for i in range(2, args.iters + 2):
        params, m, v, loss = step_fn(params, m, v, x, y, *s(i))
    loss_val = float(loss)
    dt = (time.perf_counter() - t0) / args.iters

    img_per_sec = B / dt
    mfu = F.mfu(img_per_sec, cfg, dev.device_kind, n_chips=1, train=True)
    print({"preset": args.preset, "remat": remat,
           "img_per_sec": round(img_per_sec, 1),
           "step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
           "loss": round(loss_val, 4), "B": B})


if __name__ == "__main__":
    main()
