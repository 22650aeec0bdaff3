"""LoRA — low-rank adaptation for parameter-efficient finetuning.

Beyond-reference capability: the reference can only full-finetune (its
optimizer walks the whole arena, train_vit.rs:619-668).  LoRA (Hu et al.)
freezes the base weights and learns a rank-r update  W' = W + (α/r)·B·A
per target matrix, cutting optimizer state and checkpoint size by ~100×
and letting one base model serve many adapted heads.

Shape choices:
  * adapters are stacked on the leading L axis like every canonical tensor
    (params.py), so ONE einsum per target produces all layers' deltas and
    the merged weights feed the existing `lax.scan` block unchanged;
  * the merge (B·A, an (L, OC, r)×(L, r, IC) batched matmul with r ≤ 64)
    is recomputed every step rather than kept as a separate serving path —
    at r=8 on GPT-2 124M it is <0.1% of step FLOPs, and merging preserves
    every downstream optimization (fused attention, selective remat) with
    zero extra code;
  * gradients flow to the adapters THROUGH the merge by differentiating
    w.r.t. the adapter tree only — the base tree is a closed-over constant,
    so XLA never materializes base-weight gradients or optimizer state.

State layout: {name+"_a": (L, r, IC), name+"_b": (L, OC, r)} — B zero-init
so the adapted model equals the base at step 0 (the standard LoRA init).
Persisted via checkpoint_tree.save_tree (npz; tiny).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import ViTConfig
from ..ops.optimizer import adamw_tree
from ..params import param_shapes
from . import model as M

# the four per-layer weight matrices (attention + MLP) — the standard
# "all linear layers" target set
LORA_TARGETS = ("qkvw", "attprojw", "fcw", "fcprojw")


def init_lora(cfg: ViTConfig, key: jax.Array, rank: int = 8,
              targets: Tuple[str, ...] = LORA_TARGETS) -> Dict[str, jax.Array]:
    """A ~ N(0, 0.02), B = 0 (adapted == base at init)."""
    shapes = param_shapes(cfg)
    keys = jax.random.split(key, len(targets))
    lora = {}
    for k, name in zip(keys, targets):
        L, OC, IC = shapes[name]
        lora[name + "_a"] = (jax.random.normal(k, (L, rank, IC)) * 0.02
                             ).astype(jnp.float32)
        lora[name + "_b"] = jnp.zeros((L, OC, rank), jnp.float32)
    return lora


def lora_rank(lora: Dict[str, jax.Array]) -> int:
    for name, t in lora.items():
        if name.endswith("_a"):
            return t.shape[1]
    raise ValueError("empty lora tree")


def apply_lora(params: Dict[str, jax.Array], lora: Dict[str, jax.Array],
               alpha: float = 16.0) -> Dict[str, jax.Array]:
    """Merged weights W + (α/r)·B·A per adapted target; other tensors pass
    through by reference (no copy)."""
    scale = alpha / lora_rank(lora)
    out = dict(params)
    for name in list(params):
        if name + "_a" in lora:
            A, B = lora[name + "_a"], lora[name + "_b"]
            delta = jnp.einsum("lor,lri->loi", B, A,
                               preferred_element_type=jnp.float32)
            out[name] = (params[name].astype(jnp.float32)
                         + scale * delta).astype(params[name].dtype)
    return out


def merge_lora(params: Dict[str, jax.Array], lora: Dict[str, jax.Array],
               alpha: float = 16.0) -> Dict[str, jax.Array]:
    """Bake the adapters into a standalone parameter set (for serving /
    checkpointing through the standard writer)."""
    return jax.tree_util.tree_map(jnp.asarray, apply_lora(params, lora, alpha))


def init_lora_opt(lora: Dict[str, jax.Array]):
    z = jax.tree_util.tree_map(jnp.zeros_like, lora)
    return z, jax.tree_util.tree_map(jnp.zeros_like, lora)


@functools.partial(jax.jit, static_argnames=("cfg", "alpha", "lr",
                                             "weight_decay"))
def lora_train_step(lora: Dict[str, jax.Array], m: Dict, v: Dict,
                    step: jax.Array, params: Dict[str, jax.Array],
                    inputs: jax.Array, targets: jax.Array, cfg: ViTConfig,
                    lr: float = 1e-4, alpha: float = 16.0,
                    weight_decay: float = 0.0):
    """One AdamW step on the adapter tree only.  Base `params` are a
    non-differentiated argument: XLA sees them as constants of the grad
    computation, so no base-weight gradient or optimizer state exists
    anywhere in the program."""

    def loss_fn(lo):
        merged = apply_lora(params, lo, alpha)
        return M.loss_fn(merged, inputs, targets, cfg)

    loss, g = jax.value_and_grad(loss_fn)(lora)
    lora, m, v = adamw_tree(lora, g, m, v, step + 1, lr,
                            weight_decay=weight_decay)
    return loss, lora, m, v
