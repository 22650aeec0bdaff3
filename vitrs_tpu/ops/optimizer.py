"""Optimizers over the flat parameter vector.

The reference allocates AdamW moment buffers `m`/`v` of num_parameters floats
(train_vit.rs:73-74) but its `optimizer_step` is plain SGD over the flat arena
(train_vit.rs:737-743, gap G7).  We provide both:

  * sgd_step   — the reference-as-written update, for parity mode;
  * adamw_step — the intended llm.c AdamW (bias-corrected, decoupled weight
                 decay), operating on the flat f32 vector; XLA fuses the
                 elementwise update into one memory-bound sweep.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def sgd_step(flat_params: jax.Array, flat_grads: jax.Array,
             lr: float) -> jax.Array:
    """p[i] -= lr * g[i] — train_vit.rs:737-743 verbatim semantics."""
    return flat_params - lr * flat_grads


def adamw_step(p: jax.Array, g: jax.Array, m: jax.Array, v: jax.Array,
               step: jax.Array, lr: jax.Array,
               beta1: float = 0.9, beta2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    g = g.astype(jnp.float32)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    t = step.astype(jnp.float32)
    mhat = m / (1.0 - beta1 ** t)
    vhat = v / (1.0 - beta2 ** t)
    p = p - lr * (mhat / (jnp.sqrt(vhat) + eps) + weight_decay * p)
    return p, m, v


def decay_mask_2d(params):
    """llm.c's decay policy: weight-decay only matrix-shaped tensors
    (llm.c gpt2_update counterpart) — biases, LN gains/shifts and other
    1-D vectors are not pulled toward zero."""
    return jax.tree_util.tree_map(lambda p: p.ndim >= 2, params)


def adamw_tree(params, grads, m, v, step, lr, beta1=0.9, beta2=0.999,
               eps=1e-8, weight_decay=0.0, decay_mask=None):
    """AdamW over pytrees (m/v mirror the param tree).  On a single card this
    avoids the flatten/concat round trips of the flat-vector form (~2 GB of
    pure data movement at ViT-B scale); XLA fuses each leaf's update into one
    pass over memory.  The flat form (adamw_step) remains the ZeRO-1/
    reduce-scatter and checkpoint layout (params.flatten_params maps between
    the two).

    decay_mask: optional pytree of bools — leaves marked False get
    weight_decay 0 (see decay_mask_2d for the llm.c policy)."""
    t = step.astype(jnp.float32)
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t

    def upd(p, g, m_, v_, wd=weight_decay):
        # state dtype is preserved: fp32 state is exact AdamW; bf16 state
        # (the 1.5B-on-one-chip memory mode) computes in fp32 and rounds
        # back — update math itself never runs below fp32
        sd = m_.dtype
        g = g.astype(jnp.float32)
        mf = beta1 * m_.astype(jnp.float32) + (1.0 - beta1) * g
        vf = beta2 * v_.astype(jnp.float32) + (1.0 - beta2) * g * g
        pf = p.astype(jnp.float32)
        pf = pf - lr * ((mf / bc1) / (jnp.sqrt(vf / bc2) + eps)
                        + wd * pf)
        return pf.astype(p.dtype), mf.astype(sd), vf.astype(sd)

    flat_p, treedef = jax.tree_util.tree_flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(m)
    flat_v = treedef.flatten_up_to(v)
    flat_w = (treedef.flatten_up_to(decay_mask) if decay_mask is not None
              else [True] * len(flat_p))
    out = [upd(p, g, m_, v_, weight_decay if w else 0.0)
           for p, g, m_, v_, w in zip(flat_p, flat_g, flat_m, flat_v, flat_w)]
    new_p = jax.tree_util.tree_unflatten(treedef, [o[0] for o in out])
    new_m = jax.tree_util.tree_unflatten(treedef, [o[1] for o in out])
    new_v = jax.tree_util.tree_unflatten(treedef, [o[2] for o in out])
    return new_p, new_m, new_v


def cosine_lr(step: jax.Array, base_lr: float, warmup: int, total: int,
              min_lr: float = 0.0) -> jax.Array:
    """Linear warmup + cosine decay schedule (traceable form)."""
    step = step.astype(jnp.float32)
    warm = base_lr * step / jnp.maximum(1.0, warmup)
    prog = jnp.clip((step - warmup) / jnp.maximum(1.0, total - warmup), 0.0, 1.0)
    cos = min_lr + 0.5 * (base_lr - min_lr) * (1.0 + jnp.cos(jnp.pi * prog))
    return jnp.where(step < warmup, warm, cos)


def cosine_lr_host(step: int, base_lr: float, warmup: int, total: int,
                   min_lr: float = 0.0) -> float:
    """Host-side (pure Python) twin of `cosine_lr` for the train loops.

    The schedule is driven from Python once per step; computing it with jnp
    outside jit would issue ~10 tiny device dispatches per step.  Same math
    in float32 so logged lr values match the traced schedule."""
    s = np.float32(step)
    if s < warmup:
        return float(np.float32(base_lr) * s / np.float32(max(1.0, warmup)))
    prog = np.clip((s - warmup) / np.float32(max(1.0, total - warmup)),
                   np.float32(0), np.float32(1))
    return float(np.float32(min_lr) + np.float32(0.5)
                 * (np.float32(base_lr) - np.float32(min_lr))
                 * (np.float32(1.0) + np.cos(np.float32(np.pi) * prog)))


def wsd_lr_host(step: int, base_lr: float, warmup: int, total: int,
                decay_frac: float = 0.1, min_lr: float = 0.0) -> float:
    """Warmup-Stable-Decay schedule (host-side, like cosine_lr_host): linear
    warmup, a long FLAT plateau at base_lr, then a linear cooldown over the
    final `decay_frac` of training.  The modern continued-pretraining
    schedule — unlike cosine, the plateau means a checkpoint taken at any
    mid-training step is a valid starting point for a longer run (only the
    cooldown must be re-done), so `total` can be extended after the fact."""
    s = np.float32(step)
    if s < warmup:
        return float(np.float32(base_lr) * s / np.float32(max(1.0, warmup)))
    decay_steps = np.float32(max(1.0, decay_frac * total))
    decay_start = np.float32(total) - decay_steps
    if s < decay_start:
        return float(base_lr)
    prog = np.clip((s - decay_start) / decay_steps, np.float32(0),
                   np.float32(1))
    return float(np.float32(base_lr)
                 + (np.float32(min_lr) - np.float32(base_lr)) * prog)
