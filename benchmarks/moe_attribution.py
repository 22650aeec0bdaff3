"""MoE step-time attribution on one GPU.

Attributes the sparse step's cost by constant substitution: time the full
train step under ops/moe.py MOE_DIAG variants (wrong math, identical
shapes/memory traffic):

    baseline     production routing + gather dispatch/combine
    fixedroute   static round-robin slot map — no fp32 router matmul,
                 softmax, top_k, one-hot cumsum, or aux chain
    nogather     dispatch/combine gathers -> same-shape linear copies

baseline - fixedroute = the routing-chain cost;
baseline - nogather   = the gather/index data-movement cost;
the remainder vs the dense-equivalent roofline is the expert-FFN geometry
itself (cap-padded (E, cap, 4C) matmuls vs one dense (S, 4C)).

One variant per process (env read at import):
    for v in "" fixedroute nogather; do VITRS_MOE_DIAG=$v \
        python benchmarks/moe_attribution.py; done
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
from vitrs_tpu.utils import flops as F


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cap-factor", type=float, default=1.0)
    args = ap.parse_args()

    dev = jax.devices()[0]
    cfg = get_config("gpt2-moe-8e").replace(
        dtype=backend.compute_dtype(), moe_cap_factor=args.cap_factor)
    B, T = args.batch, cfg.max_seq_len
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    from vitrs_tpu.ops import adafactor as AF
    st = AF.init_state(params)
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    x, y = tokens[:, :-1], tokens[:, 1:]

    def step(p, st):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        p, st = AF.step(p, grads, st, jnp.asarray(2, jnp.int32),
                        jnp.asarray(1e-4, jnp.float32))
        return p, st, loss

    stepf = jax.jit(step, donate_argnums=(0, 1))
    params, st, loss = stepf(params, st)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        params, st, loss = stepf(params, st)
    float(loss)
    dt = (time.perf_counter() - t0) / args.iters
    toks = B * T
    sparse_tf = B * F.train_flops_per_example(cfg)
    peak = F.peak_flops(dev.device_kind, cfg.dtype)
    print({"variant": os.environ.get("VITRS_MOE_DIAG", "") or "baseline",
           "step_ms": round(dt * 1e3, 2),
           "tok_per_sec": int(toks / dt),
           "sparse_mfu": round(sparse_tf / dt / peak, 4),
           "B": B, "T": T, "cap_factor": args.cap_factor})


if __name__ == "__main__":
    main()
