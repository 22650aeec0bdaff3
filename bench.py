"""Training throughput of the three benchmark cells on one GPU.

Cells, each at its model's published width, bf16, through the production
loss (models/model.loss_fn) and optimizer:

  vit_b16      ViT-B/16, B=64, AdamW (tree form, wd 0.05)
  gpt2_124m    GPT-2 124M, B=32, T=1024, AdamW with 2-D-only decay
  gpt2_moe_8e  the 124M geometry with 8 experts top-2 (cap factor 1.0),
               B=24, T=1024, Adafactor

Prints the card's name and power limit on one line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra"} — the ViT-B row is the
headline, the GPT and MoE rows ride in `extra`.  vs_baseline is MFU over
the 55% MFU north-star target of BASELINE.json.  Exits non-zero when JAX
finds no GPU.

    python bench.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from vitrs_tpu import backend
from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import adafactor as AF
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.utils import flops as F


def _time_steps(step, state, iters):
    """Compile and warm up on two steps, then mean seconds per step."""
    for i in (1, 2):
        state = step(*state, jnp.asarray(i, jnp.int32))
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for i in range(3, iters + 3):
        state = step(*state, jnp.asarray(i, jnp.int32))
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / iters, state


def _adamw_cell(cfg, inputs, targets, lr, wd, decay_2d, iters):
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    zeros = lambda: jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 params)

    def step(p, m, v, loss, i):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, inputs, targets, cfg)
        p, m, v = opt.adamw_tree(
            p, grads, m, v, i, jnp.asarray(lr, jnp.float32), weight_decay=wd,
            decay_mask=opt.decay_mask_2d(p) if decay_2d else None)
        return p, m, v, loss

    dt, state = _time_steps(jax.jit(step, donate_argnums=(0, 1, 2)),
                            (params, zeros(), zeros(), jnp.zeros(())), iters)
    return dt, float(state[-1])


def vit_cell(dev):
    cfg = get_config("vit-b-16", dtype="bfloat16")
    B = 64
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(
        (B, cfg.img_size, cfg.img_size, cfg.in_chans), dtype=np.float32))
    y = jnp.asarray(rng.integers(0, cfg.num_classes, (B,)))
    dt, loss = _adamw_cell(cfg, x, y, 1e-3, 0.05, False, 20)
    ips = B / dt
    return {"images_per_sec": ips, "step_ms": dt * 1e3, "batch": B,
            "mfu": F.mfu(ips, cfg, dev.device_kind),
            "loss_finite": bool(np.isfinite(loss))}


def gpt_cell(dev):
    cfg = get_config("gpt2-124m", dtype="bfloat16")
    B, T = 32, cfg.max_seq_len
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)))
    dt, loss = _adamw_cell(cfg, x, y, 3e-4, 0.1, True, 20)
    return {"tok_per_sec": B * T / dt, "step_ms": dt * 1e3, "batch": B,
            "seq": T, "mfu": F.mfu(B / dt, cfg, dev.device_kind),
            "loss_finite": bool(np.isfinite(loss))}


def moe_cell(dev):
    cfg = get_config("gpt2-moe-8e", dtype="bfloat16", moe_cap_factor=1.0)
    B, T = 24, cfg.max_seq_len
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)))
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))

    def step(p, st, loss, i):
        loss, grads = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        p, st = AF.step(p, grads, st, i, jnp.asarray(1e-4, jnp.float32))
        return p, st, loss

    dt, state = _time_steps(jax.jit(step, donate_argnums=(0, 1)),
                            (params, AF.init_state(params), jnp.zeros(())),
                            10)
    return {"tok_per_sec": B * T / dt, "step_ms": dt * 1e3, "batch": B,
            "experts": cfg.num_experts,
            "sparse_mfu": F.mfu(B / dt, cfg, dev.device_kind),
            "loss_finite": bool(np.isfinite(float(state[-1])))}


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    backend.enable_compile_cache()
    card = backend.card_description()
    print(f"card: {card}", flush=True)
    vit = vit_cell(dev)
    gpt = gpt_cell(dev)
    moe = moe_cell(dev)
    print(json.dumps({
        "metric": "ViT-B/16 train images/sec/card (bf16, AdamW)",
        "value": vit["images_per_sec"],
        "unit": "images/sec/card",
        "vs_baseline": vit["mfu"] / 0.55,
        "extra": {"device": dev.device_kind, "card": card,
                  "vit_b16": vit, "gpt2_124m": gpt, "gpt2_moe_8e": moe},
    }))


if __name__ == "__main__":
    main()
