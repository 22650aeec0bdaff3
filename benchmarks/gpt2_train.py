"""GPT-2 124M training throughput on one GPU.

The reference's own config (reference tests/vit_tests.rs:10-15:
max_seq_len=1024, vocab=50257, L=12, NH=12, C=768). Measures tok/s and MFU
for a full fused train step (fwd + bwd + AdamW).

Usage: python benchmarks/gpt2_train.py [--batch 8] [--iters 20]
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
    ap.add_argument("--preset", default="gpt2-124m",
                    help="gpt2-124m / gpt2-350m / gpt2-774m / gpt2-1558m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--param-dtype", default=None,
                    help="bfloat16 fits GPT-2 1.5B on one 16 GB chip")
    ap.add_argument("--state-dtype", default="float32",
                    help="AdamW m/v dtype (bfloat16 for the 1.5B mode)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention width (0 = full causal)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="GQA/MQA K/V head count (0 = MHA)")
    ap.add_argument("--pos-emb", default="learned",
                    choices=["learned", "rope"])
    ap.add_argument("--num-experts", type=int, default=0,
                    help="MoE experts per layer (0 = dense MLP)")
    ap.add_argument("--moe-top-k", type=int, default=2)
    ap.add_argument("--cap-factor", type=float, default=0.0,
                    help="MoE static-capacity factor (0 = config default "
                         "1.25; 1.0 trades routing drops for ~20% fewer "
                         "padded expert rows)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"],
                    help="adafactor = sublinear optimizer state "
                         "(ops/adafactor.py) — the big-model memory mode")
    ap.add_argument("--scan-unroll", type=int, default=0,
                    help="layer-scan unroll factor (0 = full unroll — "
                         "fastest steady-state; 1 = rolled scan, O(1) "
                         "compile size in depth: use for MoE whose "
                         "top-k/scatter HLO is large per layer)")
    args = ap.parse_args()

    dev = jax.devices()[0]
    cfg = get_config(args.preset).replace(
        dtype=backend.compute_dtype(), max_seq_len=args.seq, remat=args.remat,
        window=args.window, num_kv_heads=args.kv_heads, pos_emb=args.pos_emb,
        num_experts=args.num_experts, scan_unroll=args.scan_unroll,
        **({"moe_top_k": args.moe_top_k} if args.num_experts else {}),
        **({"moe_cap_factor": args.cap_factor} if args.cap_factor else {}),
        **({"param_dtype": args.param_dtype} if args.param_dtype else {}))
    B, T = args.batch, cfg.max_seq_len

    key = jax.random.PRNGKey(0)
    params = PRM.init_params(cfg, key)
    state_dtype = jnp.dtype(args.state_dtype)
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    x, y = tokens[:, :-1], tokens[:, 1:]

    if args.optimizer == "adafactor":
        from vitrs_tpu.ops import adafactor as AF
        af_state = AF.init_state(params)
        mask = opt.decay_mask_2d(params)
        print({"adafactor_state_mb":
               round(AF.state_bytes(af_state) / 2**20, 1)})

        def train_step(p, st, x, y, step, lr):
            loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
            p, st = AF.step(p, grads, st, step, lr, weight_decay=0.1,
                            decay_mask=mask)
            return p, st, loss

        step_fn = jax.jit(train_step, donate_argnums=(0, 1))
        s = lambda i: (jnp.asarray(i, jnp.int32),
                       jnp.asarray(1e-2, jnp.float32))
        params, af_state, loss = step_fn(params, af_state, x, y, *s(1))
        float(loss)
        t0 = time.perf_counter()
        for i in range(2, args.iters + 2):
            params, af_state, loss = step_fn(params, af_state, x, y, *s(i))
        loss_val = float(loss)
        dt = (time.perf_counter() - t0) / args.iters
        tok_per_sec = B * T / dt
        mfu = F.mfu(tok_per_sec / T, cfg, dev.device_kind, n_chips=1,
                    train=True)
        print({"tok_per_sec": round(tok_per_sec),
               "step_ms": round(dt * 1e3, 2), "mfu": round(mfu, 4),
               "loss": round(loss_val, 4), "B": B, "T": T})
        return

    zeros = lambda: jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, state_dtype), params)
    m, v = zeros(), zeros()

    def train_step(p, m, v, x, y, step, lr):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        p, m, v = opt.adamw_tree(p, grads, m, v, step, lr, weight_decay=0.1)
        return p, m, v, loss

    step_fn = jax.jit(train_step, donate_argnums=(0, 1, 2))
    s = lambda i: (jnp.asarray(i, jnp.int32), jnp.asarray(1e-4, jnp.float32))

    params, m, v, loss = step_fn(params, m, v, x, y, *s(1))
    float(loss)

    if args.profile:
        from vitrs_tpu.utils.profiling import print_breakdown
        prof_fn = jax.jit(train_step)   # no donation: profiler re-feeds args
        print_breakdown(lambda p, m, v: prof_fn(p, m, v, x, y, *s(2)),
                        params, m, v)
        return

    t0 = time.perf_counter()
    for i in range(2, args.iters + 2):
        params, m, v, loss = step_fn(params, m, v, x, y, *s(i))
    loss_val = float(loss)
    dt = (time.perf_counter() - t0) / args.iters

    tok_per_sec = B * T / dt
    mfu = F.mfu(tok_per_sec / T, cfg, dev.device_kind, n_chips=1, train=True)
    print({"tok_per_sec": round(tok_per_sec), "step_ms": round(dt * 1e3, 2),
           "mfu": round(mfu, 4), "loss": round(loss_val, 4), "B": B, "T": T})


if __name__ == "__main__":
    main()
