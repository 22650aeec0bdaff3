"""Attention over the packed qkv projection.

The reference materializes the full O(B*NH*T^2) `preatt`/`att` buffers
(rusty_vit.rs:157-158) and loops scalar-wise (rusty_vit.rs:512-563).  The
production path here is `jax.nn.dot_product_attention`, in the form the rule
in backend.attention_implementation picks: cuDNN's fused flash attention on
a GPU for bf16, XLA's own form otherwise.  The dense path
(ops/basic.attention_dense) keeps the reference's stash semantics for parity
tests and quirks mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import backend
from . import basic


def fused_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                    num_heads: int, kv_heads: int, causal: bool = True,
                    window: int = 0) -> jax.Array:
    """q (B, T, num_heads·D), k/v (B, T, kv_heads·D) -> (B, T, num_heads·D).

    The packed layouts reshape to BTNH with no transpose.  K/V keep their
    kv_heads heads: GQA/MQA is native, no expansion.  window > 0 (causal
    only): query t attends keys in (t-window, t], which is
    local_window_size=(window-1, 0)."""
    B, T, C = q.shape
    D = C // num_heads
    impl = backend.attention_implementation(jax.default_backend(), q.dtype,
                                            D, T)
    out = jax.nn.dot_product_attention(
        q.reshape(B, T, num_heads, D),
        k.reshape(B, T, kv_heads, D),
        v.reshape(B, T, kv_heads, D),
        is_causal=causal,
        local_window_size=(window - 1, 0) if window else None,
        implementation=impl)
    return out.reshape(B, T, C)


def attention(qkv: jax.Array, num_heads: int, causal: bool = True,
              quirks: bool = False, use_flash: bool = True,
              window: int = 0, rope: bool = False,
              kv_heads: int = 0) -> jax.Array:
    """Multi-head attention over packed qkv (B, T, C + 2·kv_dim) -> (B, T, C).
    kv_heads (0 = num_heads) selects GQA/MQA.  window > 0 (causal only) =
    sliding-window attention.

    rope=True takes UNROTATED qkv and rotates q/k at positions 0..T-1
    before attending, so callers (e.g. the TP block) never rotate.
    quirks or use_flash=False take the dense reference path."""
    assert causal or not window, "sliding-window attention is causal-only"
    kv_heads = kv_heads or num_heads
    q, k, v = split_gqa(qkv, num_heads, kv_heads)
    if rope:
        from .rope import rope_qk
        q, k = rope_qk(q, k, jnp.arange(qkv.shape[1]), num_heads, kv_heads)
    if quirks or not use_flash:
        packed = jnp.concatenate([q, expand_kv_heads(k, kv_heads, num_heads),
                                  expand_kv_heads(v, kv_heads, num_heads)],
                                 axis=-1)
        out, _ = basic.attention_dense(packed, num_heads, causal=causal,
                                       quirks=quirks, window=window)
        return out
    return fused_attention(q, k, v, num_heads, kv_heads, causal, window)


def expand_kv_heads(kv: jax.Array, kv_heads: int, num_heads: int) -> jax.Array:
    """GQA/MQA K-or-V expansion: (B, T, kv_heads*D) -> (B, T, num_heads*D).

    KV head g is shared by the G = num_heads//kv_heads consecutive query
    heads [g*G, (g+1)*G) (the Llama/GQA convention).  jnp.repeat on the head
    axis; its autodiff transpose is the per-group segment sum, which is
    exactly the GQA dk/dv reduction."""
    if kv_heads == num_heads:
        return kv
    B, T, kvd = kv.shape
    D = kvd // kv_heads
    G = num_heads // kv_heads
    return jnp.repeat(kv.reshape(B, T, kv_heads, D), G,
                      axis=2).reshape(B, T, num_heads * D)


def split_gqa(qkv: jax.Array, num_heads: int, kv_heads: int):
    """Split a packed GQA projection (B, T, C + 2*kv_dim) into q/k/v parts.
    C = num_heads*D, kv_dim = kv_heads*D — solved from the static packed
    width W = (num_heads + 2*kv_heads)*D."""
    W = qkv.shape[-1]
    C = W * num_heads // (num_heads + 2 * kv_heads)
    kvd = (W - C) // 2
    return qkv[..., :C], qkv[..., C:C + kvd], qkv[..., C + kvd:]


def expand_packed(qkv: jax.Array, num_heads: int, kv_heads: int
                  ) -> jax.Array:
    """Packed GQA projection (B, T, C + 2*kv_dim) -> packed MHA (B, T, 3C):
    the ONE place the packed-GQA slicing + group expansion convention lives
    (the dense reference paths and the ring-attention step call this)."""
    if not kv_heads or kv_heads == num_heads:
        return qkv
    q, k, v = split_gqa(qkv, num_heads, kv_heads)
    return jnp.concatenate([q, expand_kv_heads(k, kv_heads, num_heads),
                            expand_kv_heads(v, kv_heads, num_heads)], axis=-1)
