"""int8 post-training quantization for inference/serving.

Two execution modes, chosen by what bounds the workload:

  * weight-only (`linear_w8`): weights stored int8 + per-out-channel f32
    scale, dequantized to the activation dtype *inside* the matmul operand
    fusion (XLA folds `wq * scale` into the operand read).  Halves weight
    memory traffic vs bf16 — the lever for bandwidth-bound workloads
    (KV-cache generation reads every weight once per token).  The matmul
    stays bf16, so accuracy loss is just the int8 weight rounding.

  * dynamic w8a8 (`linear_w8a8`): per-token (row) symmetric activation
    quantization + int8 x int8 matmul with int32 accumulation — the lever
    for compute-bound batch serving where int8 runs faster than bf16.

Both use symmetric per-out-channel scales (scale = amax/127, no zero
point): transformer weight distributions are near-symmetric, so a zero
point buys little.

The reference has no quantization (its serving story is f32 `forward` with
targets absent, rusty_vit.rs:269-350); this subsystem extends the serving
surface.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

# weight leaves quantized per mode; everything else (LN, biases, pos-embed,
# cls token) stays f32 — they are O(C) and numerically load-bearing
_QUANT_KEYS_GPT = ("qkvw", "attprojw", "fcw", "fcprojw", "wte")
_QUANT_KEYS_VIT = ("qkvw", "attprojw", "fcw", "fcprojw", "patchw", "headw")


def quantize_weight(w: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(..., OC, C) f32 -> (int8 same shape, f32 scale (..., OC)).

    Symmetric per-out-channel: scale = amax/127 over the contraction axis
    (last), so dequant is `wq * scale[..., None]`.
    """
    w = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=-1)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    wq = jnp.clip(jnp.round(w / scale[..., None]), -127, 127).astype(jnp.int8)
    return wq, scale


def linear_w8(x: jax.Array, wq: jax.Array, scale: jax.Array,
              b: Optional[jax.Array] = None) -> jax.Array:
    """Weight-only int8 linear; y = x @ dequant(wq).T (+ b), W (OC, C)."""
    w = (wq.astype(x.dtype) * scale[..., None].astype(x.dtype))
    y = jax.lax.dot_general(
        x, w, dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(x.dtype)
    if b is not None:
        y = y + b.astype(x.dtype)
    return y


def linear_w8a8(x: jax.Array, wq: jax.Array, scale: jax.Array,
                b: Optional[jax.Array] = None) -> jax.Array:
    """Dynamic-activation int8 linear: per-row symmetric x quant, int8 matmul.

    y[r, o] = (sum_c xq[r, c] * wq[o, c]) * ax[r] * scale[o]  (+ b[o])
    with int32 accumulation.
    """
    xf = x.astype(jnp.float32)
    ax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    ax = jnp.where(ax > 0, ax / 127.0, 1.0)                   # (..., 1)
    xq = jnp.clip(jnp.round(xf / ax), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, wq, dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * ax * scale.astype(jnp.float32)
    if b is not None:
        y = y + b.astype(jnp.float32)
    return y.astype(x.dtype)


def quantize_params(params: Dict[str, jax.Array], mode: str = "vit"
                    ) -> Dict[str, jax.Array]:
    """Quantize the matmul weights of a trained model for serving.

    Returns a new dict: each quantized leaf `k` is replaced by `k` (int8)
    plus `k + '_scale'` (f32 per-out-channel, stacked-L where the weight
    is); all other leaves pass through unchanged.
    """
    keys = _QUANT_KEYS_GPT if mode == "gpt" else _QUANT_KEYS_VIT
    out: Dict[str, jax.Array] = {}
    for k, v in params.items():
        if k in keys:
            wq, scale = quantize_weight(v)
            out[k] = wq
            out[k + "_scale"] = scale
        else:
            out[k] = v
    return out


def dequantize_params(qparams: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    """Inverse of quantize_params (up to int8 rounding) — for running the
    standard float forward on quantized weights (weight-only semantics)."""
    out = {}
    for k, v in qparams.items():
        if k.endswith("_scale"):
            continue
        if k + "_scale" in qparams:
            out[k] = (v.astype(jnp.float32)
                      * qparams[k + "_scale"][..., None].astype(jnp.float32))
        else:
            out[k] = v
    return out
