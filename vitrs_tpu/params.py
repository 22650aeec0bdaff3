"""Parameter memory model.

The reference keeps 16 parameter tensors in a fixed canonical order inside one flat
f32 arena (/root/reference/rusty_vit.rs:105-148, train_vit.rs:115-162).  We keep the
same canonical order and sizes — it defines the checkpoint payload layout (§2.1 of
SURVEY.md) — but hold the live parameters as a pytree of `jax.Array`s shaped for the
compute path:

  * per-layer tensors are stacked on a leading L axis (exactly the reference's
    "per-layer slabs stacked along the leading dim", rusty_vit.rs:292-303), which is
    the natural layout for `lax.scan` over blocks;
  * matmul weights keep the reference's (OC, C) row-major convention, consumed as
    y = x @ W.T + b (rusty_vit.rs:484-498).

`flatten_params` / `unflatten_params` give the flat 1-D view used by the fused
AdamW kernel and the checkpoint writer, byte-compatible with the reference arena.

ViT mode adds extension tensors (patch embedding, CLS token, classifier head) that
live *after* the canonical 16 in the v2 checkpoint section (see checkpoint.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import ViTConfig

# Canonical order and shapes of the 16 reference tensors
# (rusty_vit.rs:105-122; sizes verified by tests/vit_tests.rs:15 → 124,439,808).
CANONICAL_16 = (
    "wte", "wpe", "ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
    "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb", "lnfw", "lnfb",
)

# ViT-mode extension tensors (v2 checkpoint section), canonical order.
VIT_EXT = ("patchw", "patchb", "cls", "headw", "headb")

# MoE extension tensor (v2 checkpoint section, after any VIT_EXT): the
# router.  The expert-stacked MLP weights keep their canonical names/slots —
# fcw/fcb/fcprojw/fcprojb simply grow a leading E axis (header h[19] declares
# num_experts, so the payload layout stays self-describing).
MOE_EXT = ("routerw",)


def param_shapes(cfg: ViTConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes in canonical order. Leading L axis on per-layer tensors."""
    L, C, V, T = cfg.num_layers, cfg.channels, cfg.vocab_size, cfg.max_seq_len
    shapes = {
        "wte": (V, C),
        "wpe": (T, C),
        "ln1w": (L, C), "ln1b": (L, C),
        # qkv_dim == 3C for MHA (the reference layout); C + 2*kv_dim under
        # GQA/MQA (beyond-reference; config.num_kv_heads)
        "qkvw": (L, cfg.qkv_dim, C), "qkvb": (L, cfg.qkv_dim),
        "attprojw": (L, C, C), "attprojb": (L, C),
        "ln2w": (L, C), "ln2b": (L, C),
        "fcw": (L, 4 * C, C), "fcb": (L, 4 * C),
        "fcprojw": (L, C, 4 * C), "fcprojb": (L, C),
        "lnfw": (C,), "lnfb": (C,),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        shapes.update({
            "fcw": (L, E, 4 * C, C), "fcb": (L, E, 4 * C),
            "fcprojw": (L, E, C, 4 * C), "fcprojb": (L, E, C),
            "routerw": (L, E, C),
        })
    if cfg.mode == "vit":
        P, IC, NC = cfg.patch_size, cfg.in_chans, cfg.num_classes
        shapes.update({
            "patchw": (C, P * P * IC),           # (OC, C_in) convention like all matmuls
            "patchb": (C,),
            "cls": (1, 1, C),
            "headw": (NC, C),
            "headb": (NC,),
        })
    return shapes


def tensor_order(cfg: ViTConfig) -> Tuple[str, ...]:
    return (CANONICAL_16 + (VIT_EXT if cfg.mode == "vit" else ())
            + (MOE_EXT if cfg.num_experts else ()))


def num_parameters(cfg: ViTConfig, core_only: bool = False) -> int:
    shapes = param_shapes(cfg)
    names = CANONICAL_16 if core_only else tensor_order(cfg)
    return int(sum(int(np.prod(shapes[n])) for n in names))


def init_params(cfg: ViTConfig, key: jax.Array, scheme: str = "production") -> Dict[str, jax.Array]:
    """Initialize the parameter pytree.

    scheme="reference": uniform [0, 0.02) on weight matrices, LN scales = 1, all
    biases 0 — matching the reference's `init_parameters` (rusty_vit.rs:864-903,
    which uses `rand::random::<f32>() * 0.02`, i.e. *uniform*, not normal).
    scheme="production": trunc-normal(0.02) weights, zeros biases, LN=1, plus
    depth-scaled residual-projection init (GPT-2/ViT standard practice).
    """
    shapes = param_shapes(cfg)
    dtype = jnp.dtype(cfg.param_dtype)
    names = tensor_order(cfg)
    keys = dict(zip(names, jax.random.split(key, len(names))))
    params = {}
    for name in names:
        shp = shapes[name]
        if name in ("ln1w", "ln2w", "lnfw"):
            params[name] = jnp.ones(shp, dtype)
        elif name.endswith("b"):
            params[name] = jnp.zeros(shp, dtype)
        elif name == "cls":
            params[name] = jnp.zeros(shp, dtype)
        else:  # weight matrices / embeddings
            if scheme == "reference":
                params[name] = jax.random.uniform(keys[name], shp, dtype) * 0.02
            else:
                std = 0.02
                if name in ("attprojw", "fcprojw"):
                    std = 0.02 / np.sqrt(2.0 * cfg.num_layers)
                params[name] = (jax.random.truncated_normal(keys[name], -2.0, 2.0, shp)
                                * std).astype(dtype)
    return params


def flatten_params(params: Dict[str, jax.Array], cfg: ViTConfig) -> jax.Array:
    """Flat 1-D f32 view in canonical order (the reference's params arena)."""
    return jnp.concatenate(
        [params[n].astype(jnp.float32).reshape(-1) for n in tensor_order(cfg)])


def unflatten_params(flat: jax.Array, cfg: ViTConfig) -> Dict[str, jax.Array]:
    shapes = param_shapes(cfg)
    dtype = jnp.dtype(cfg.param_dtype)
    out, off = {}, 0
    for n in tensor_order(cfg):
        size = int(np.prod(shapes[n]))
        out[n] = flat[off:off + size].reshape(shapes[n]).astype(dtype)
        off += size
    assert off == flat.shape[0], (off, flat.shape)
    return out


def zeros_like_params(params: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    return jax.tree_util.tree_map(jnp.zeros_like, params)


def split_sizes(cfg: ViTConfig) -> List[int]:
    shapes = param_shapes(cfg)
    return [int(np.prod(shapes[n])) for n in tensor_order(cfg)]
