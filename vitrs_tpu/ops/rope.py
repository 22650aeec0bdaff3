"""Rotary positional embeddings (RoPE) — beyond-reference positional option.

The reference's only positional scheme is a learned wpe table added at encode
time (rusty_vit.rs:107, 273-281), which caps context at the table length and
carries V·C extra parameters.  RoPE (Su et al., RoFormer) instead rotates
each query/key head pair by a position-dependent angle, making attention
scores a function of RELATIVE distance:

    q'_t = R(θ·t) q_t,   k'_s = R(θ·s) k_s   =>   q'_t · k'_s = f(q, k, t−s)

The rotation is an elementwise pass that XLA fuses with its neighbours; the
half-split pairing (dims [0, D/2) with [D/2, D) — the GPT-NeoX/Llama
convention) keeps each half contiguous.  It is applied to q/k before the
attention op (ops/attention.py), and its VJP is the inverse rotation
(R is orthogonal), which autodiff derives.

config.pos_emb="rope" selects this path; the wpe table is kept in the
parameter set (the canonical 16-tensor checkpoint layout is never
reordered — params.py) but is not read, receives zero gradient, and is
excluded from decayed matrices by the 2D-decay policy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_BASE = 10000.0


def rope_angles(pos: jax.Array, head_dim: int,
                base: float = DEFAULT_BASE) -> tuple:
    """(cos, sin) tables for positions `pos` (any shape P), each
    (*P, head_dim/2) f32.  inv_freq follows the RoFormer geometric series."""
    half = head_dim // 2
    inv_freq = base ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    ang = pos.astype(jnp.float32)[..., None] * inv_freq     # (*P, half)
    return jnp.cos(ang), jnp.sin(ang)


def apply_rope(x: jax.Array, pos: jax.Array, num_heads: int,
               base: float = DEFAULT_BASE, inverse: bool = False) -> jax.Array:
    """Rotate packed heads: x (B, T, H·D).  pos: scalar, (T,) sequence
    positions, (B, 1) per-example start (decode slots), or full (B, T).
    inverse=True applies R(−θ) — the transpose."""
    B, T, C = x.shape
    D = C // num_heads
    half = D // 2
    xf = x.astype(jnp.float32).reshape(B, T, num_heads, 2, half)
    pos = jnp.asarray(pos)
    if pos.ndim == 0:
        pos = pos[None, None]
    elif pos.ndim == 1:                                     # (T,) seq positions
        pos = pos[None, :]
    pos = jnp.broadcast_to(pos, (B, T))
    cos, sin = rope_angles(pos, D, base)                    # (B, T, half)
    if inverse:
        sin = -sin
    cos = cos[:, :, None]                                   # (B, T, 1, half)
    sin = sin[:, :, None]
    x1, x2 = xf[..., 0, :], xf[..., 1, :]
    out = jnp.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-2)
    return out.reshape(B, T, C).astype(x.dtype)


def rope_qk(q: jax.Array, k: jax.Array, pos: jax.Array, num_heads: int,
            kv_heads: int = 0, base: float = DEFAULT_BASE):
    """Rotate q (B,T,C) and k (B,T,kv_dim) with shared positions.  k may
    carry fewer heads (GQA) — the rotation is per-head so the head counts
    are independent."""
    kh = kv_heads or num_heads
    return (apply_rope(q, pos, num_heads, base),
            apply_rope(k, pos, kh, base))
