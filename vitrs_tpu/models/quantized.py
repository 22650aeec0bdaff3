"""int8 inference forwards (post-training quantization, ops/quant.py).

Mirrors the float forward orchestration (models/model.py — the reference's
`ViT::forward`, rusty_vit.rs:269-351) with every matmul routed through the
quantized linears.  Activations stay bf16/f32: LayerNorm, GELU, residuals,
softmax and the attention op are untouched, so the numerical
delta vs the float model is exactly the weight-rounding (w8) or
weight+activation-rounding (w8a8) error, which the tests bound.

Weight-only (`w8a8=False`) halves weight memory reads — for bandwidth-bound
generation.  Dynamic w8a8 runs the matmuls in int8 with int32 accumulation
— for compute-bound batch serving.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from ..config import ViTConfig
from ..ops import basic, quant
from ..ops.attention import attention

QBLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvw_scale", "qkvb",
               "attprojw", "attprojw_scale", "attprojb",
               "ln2w", "ln2b", "fcw", "fcw_scale", "fcb",
               "fcprojw", "fcprojw_scale", "fcprojb")


def _qlinear(x, wq, scale, b, w8a8: bool):
    f = quant.linear_w8a8 if w8a8 else quant.linear_w8
    return f(x, wq, scale, b)


def _qblock(x: jax.Array, p: Dict[str, jax.Array], cfg: ViTConfig,
            causal: bool, w8a8: bool) -> jax.Array:
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = _qlinear(ln1, p["qkvw"], p["qkvw_scale"], p["qkvb"], w8a8)
    atty = attention(qkv, cfg.num_heads, causal=causal,
                     use_flash=cfg.use_flash)
    x = x + _qlinear(atty, p["attprojw"], p["attprojw_scale"],
                     p["attprojb"], w8a8)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    fch = _qlinear(ln2, p["fcw"], p["fcw_scale"], p["fcb"], w8a8)
    fch = basic.gelu_cv(fch)
    return x + _qlinear(fch, p["fcprojw"], p["fcprojw_scale"],
                        p["fcprojb"], w8a8)


def _qtransformer(x: jax.Array, qparams: Dict[str, jax.Array],
                  cfg: ViTConfig, causal: bool, w8a8: bool) -> jax.Array:
    blocks = {k: qparams[k] for k in QBLOCK_KEYS}
    body = functools.partial(_qblock, cfg=cfg, causal=causal, w8a8=w8a8)

    def step(carry, p):
        return body(carry, p), None

    unroll = True if cfg.scan_unroll == 0 else cfg.scan_unroll
    x, _ = jax.lax.scan(step, x, blocks, unroll=unroll)
    return x


def vit_forward_q(qparams: Dict[str, jax.Array], images: jax.Array,
                  cfg: ViTConfig, w8a8: bool = True) -> jax.Array:
    """Quantized twin of model.vit_forward; returns class logits (B, NC)."""
    dtype = jnp.dtype(cfg.dtype)
    patches = basic.patchify(images, cfg.patch_size)
    x = _qlinear(patches.astype(dtype), qparams["patchw"],
                 qparams["patchw_scale"], qparams["patchb"], w8a8)
    n_prefix = 1 if cfg.pool == "cls" else 0
    x = x + qparams["wpe"][None, n_prefix:n_prefix + x.shape[1], :].astype(dtype)
    if cfg.pool == "cls":
        cls = (qparams["cls"] + qparams["wpe"][None, :1, :]).astype(dtype)
        x = jnp.concatenate(
            [jnp.broadcast_to(cls, (x.shape[0], 1, x.shape[2])), x], axis=1)
    x = _qtransformer(x, qparams, cfg, causal=False, w8a8=w8a8)
    lnf = basic.layernorm_cv(x, qparams["lnfw"], qparams["lnfb"])
    pooled = lnf[:, 0, :] if cfg.pool == "cls" else jnp.mean(lnf, axis=1)
    # classifier head: weight-only even in w8a8 mode — it is tiny (NC x C)
    # and its logit error feeds argmax directly
    return quant.linear_w8(pooled, qparams["headw"], qparams["headw_scale"],
                           qparams["headb"]).astype(jnp.float32)


def gpt_forward_q(qparams: Dict[str, jax.Array], tokens: jax.Array,
                  cfg: ViTConfig, w8a8: bool = False) -> jax.Array:
    """Quantized twin of model.gpt_forward; returns logits (B, T, V).

    The embedding lookup dequantizes just the gathered rows of the int8
    wte (weight tying, rusty_vit.rs:336): V*C int8 + V f32 scales is the
    only stored copy.
    """
    dtype = jnp.dtype(cfg.dtype)
    T = tokens.shape[-1]
    rows = qparams["wte"][tokens].astype(dtype)
    emb = rows * qparams["wte_scale"][tokens][..., None].astype(dtype)
    x = emb + qparams["wpe"][None, :T, :].astype(dtype)
    x = _qtransformer(x, qparams, cfg, causal=True, w8a8=w8a8)
    lnf = basic.layernorm_cv(x, qparams["lnfw"], qparams["lnfb"])
    return _qlinear(lnf, qparams["wte"], qparams["wte_scale"], None, w8a8)
