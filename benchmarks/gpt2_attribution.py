"""GPT-2 124M step-time attribution on one GPU.

Splits the train step into donated-jit stages (fwd-only, fwd+bwd, full
fwd+bwd+AdamW) so each stage's share of the step can be compared against
the pure-matmul ceiling (benchmarks/matmul_ceiling.py).

Usage: python benchmarks/gpt2_attribution.py [--batch 32] [--iters 10]
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


def timeit(f, *a, iters=10, sync=float):
    r = f(*a)
    sync(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = f(*a)
    sync(r)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gpt2-124m")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    dev = jax.devices()[0]
    cfg = get_config(args.preset).replace(dtype=backend.compute_dtype())
    B, T = args.batch, cfg.max_seq_len

    key = jax.random.PRNGKey(0)
    params = PRM.init_params(cfg, key)
    zeros = lambda: jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    m, v = zeros(), zeros()
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    x, y = tokens[:, :-1], tokens[:, 1:]

    # stage jits — no donation so the same buffers re-feed every call
    fwd = jax.jit(lambda p: M.loss_fn(p, x, y, cfg))

    def _grad(p):
        return jax.value_and_grad(M.loss_fn)(p, x, y, cfg)

    gradf = jax.jit(_grad)
    sync_g = lambda r: float(r[0]) + float(jnp.sum(r[1]["lnfb"]))

    def _step(p, m, v):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        p, m, v = opt.adamw_tree(p, grads, m, v,
                                 jnp.asarray(2, jnp.int32),
                                 jnp.asarray(1e-4, jnp.float32),
                                 weight_decay=0.1)
        return p, m, v, loss

    stepf = jax.jit(_step)
    sync_s = lambda r: float(r[3]) + float(jnp.sum(r[0]["lnfb"]))

    t_f = timeit(fwd, params, iters=args.iters)
    t_g = timeit(gradf, params, iters=args.iters, sync=sync_g)
    t_s = timeit(stepf, params, m, v, iters=args.iters, sync=sync_s)

    tf_step = B * F.train_flops_per_example(cfg) / 1e12
    # stage FLOPs: fwd = 1 unit of the 3x fwd+bwd accounting
    tf_fwd = tf_step / 3.0
    ceiling = F.peak_flops(dev.device_kind, cfg.dtype) / 1e12
    report = {
        "fwd_ms": round(t_f * 1e3, 2),
        "fwd_bwd_ms": round(t_g * 1e3, 2),
        "full_step_ms": round(t_s * 1e3, 2),
        "bwd_ms": round((t_g - t_f) * 1e3, 2),
        "optimizer_ms": round((t_s - t_g) * 1e3, 2),
        "fwd_tf_s": round(tf_fwd / t_f, 1),
        "bwd_tf_s": round(2 * tf_fwd / (t_g - t_f), 1),
        "roofline_ms_at_peak": round(tf_step / ceiling * 1e3, 2),
        "achieved_vs_peak": round((tf_step / t_s) / ceiling, 3),
        "B": B, "T": T,
    }
    print(report)


if __name__ == "__main__":
    main()
