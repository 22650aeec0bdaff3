"""Core JAX ops — the re-design of the reference's L1 kernel layer.

The reference implements these as scalar raw-pointer loops
(rusty_vit.rs:460-854).  Here each op is a pure function on jax.Arrays; XLA
fuses the elementwise work into the surrounding matmuls and hands the matmuls
to the tensor cores.  Where the reference stashes tensors for its
hand-written backward (LN mean/rstd, attention att), we expose the same values
so the parity tests can compare intermediates, but the production training path
just uses jax.grad and lets XLA pick what to keep.

Every function documents the reference lines it corresponds to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

LN_EPS = 1e-5             # rusty_vit.rs:579
GELU_COEF = 0.044715      # rusty_vit.rs:619
QUIRK_MAX_INIT = -10000.0  # rusty_vit.rs:524,640 (gap G11)


def layernorm(x: jax.Array, w: jax.Array, b: jax.Array,
              ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """LayerNorm over the trailing axis; returns (out, mean, rstd) — the same
    stash contract as rusty_vit.rs:578-605.  Statistics always in fp32 (bf16
    activations lose too much in the variance reduction); output back in the
    input dtype."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1)
    var = jnp.mean(jnp.square(xf - mean[..., None]), axis=-1)
    rstd = jax.lax.rsqrt(var + LN_EPS)
    out = (xf - mean[..., None]) * rstd[..., None] * w.astype(jnp.float32) \
        + b.astype(jnp.float32)
    return out.astype(x.dtype), mean, rstd


@jax.custom_vjp
def layernorm_cv(x: jax.Array, w: jax.Array, b: jax.Array) -> jax.Array:
    """LayerNorm with a hand-written VJP — the production-path form.

    Saves only (x in its own dtype, w, mean, rstd) and recomputes the
    normalization in backward: without this, XLA keeps fp32 copies of every
    LN output alive through the scan (450 MB per stacked tensor at ViT-B/16
    B=64 — measured OOM driver).  The stash (mean, rstd) and the gradient
    formula mirror the reference's layernorm_backward exactly
    (rusty_vit.rs:737-783)."""
    out, _, _ = layernorm(x, w, b)
    return out


def _layernorm_cv_fwd(x, w, b):
    out, mean, rstd = layernorm(x, w, b)
    return out, (x, w, mean, rstd)


def layernorm_bwd_from_stats(x, w, mean, rstd, dout):
    """LN backward from saved (mean, rstd) — the reference's stash contract
    (rusty_vit.rs:737-783).  Shared by the custom-VJP LN and the selective
    remat branches (models/selective.py), which recompute the normalization
    instead of saving the LN output."""
    xf = x.astype(jnp.float32)
    df = dout.astype(jnp.float32)
    norm = (xf - mean[..., None]) * rstd[..., None]
    dnorm = df * w.astype(jnp.float32)
    red = tuple(range(dout.ndim - 1))
    db = jnp.sum(df, axis=red)
    dw = jnp.sum(norm * df, axis=red)
    dnorm_mean = jnp.mean(dnorm, axis=-1, keepdims=True)
    dnorm_norm_mean = jnp.mean(dnorm * norm, axis=-1, keepdims=True)
    dx = (dnorm - dnorm_mean - norm * dnorm_norm_mean) * rstd[..., None]
    return dx.astype(x.dtype), dw.astype(w.dtype), db.astype(w.dtype)


def _layernorm_cv_bwd(res, dout):
    x, w, mean, rstd = res
    return layernorm_bwd_from_stats(x, w, mean, rstd, dout)


layernorm_cv.defvjp(_layernorm_cv_fwd, _layernorm_cv_bwd)


@jax.custom_vjp
def gelu_cv(x: jax.Array) -> jax.Array:
    """tanh-GELU with hand-written VJP: saves only x (its own dtype) and
    recomputes the analytic gradient (rusty_vit.rs:793-807) in fp32 —
    otherwise XLA stashes fp32 tanh intermediates of the 4C-wide MLP
    activation through the scan."""
    return gelu(x)


def _gelu_cv_fwd(x):
    return gelu(x), (x,)


def gelu_grad_local(xf: jax.Array) -> jax.Array:
    """d gelu(x)/dx in fp32 (analytic tanh-GELU grad, rusty_vit.rs:793-807
    with the G15 doubled-argument defect corrected).  Shared by the GELU
    custom VJP and the selective-remat MLP branch."""
    s = jnp.sqrt(2.0 / jnp.pi).astype(jnp.float32)
    cube = GELU_COEF * xf * xf * xf
    a = s * (xf + cube)
    t = jnp.tanh(a)
    sech2 = 1.0 - t * t
    return 0.5 * (1.0 + t) + xf * 0.5 * sech2 * s * (1.0 + 3.0 * GELU_COEF * xf * xf)


def _gelu_cv_bwd(res, dout):
    (x,) = res
    xf = x.astype(jnp.float32)
    local = gelu_grad_local(xf)
    return ((local * dout.astype(jnp.float32)).astype(x.dtype),)


gelu_cv.defvjp(_gelu_cv_fwd, _gelu_cv_bwd)


INV_SQRT2 = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327


def gelu_erf(x: jax.Array) -> jax.Array:
    """Exact (erf) GELU: 0.5·x·(1 + erf(x/√2)).

    The reference only ever uses the tanh approximation
    (rusty_vit.rs:614-623); this variant exists for cross-framework weight
    import — HF ViT checkpoints (hidden_act="gelu") were trained with the
    erf form, and the ~1e-3 pointwise difference is systematic across 4C·L
    activations.  Selected via ViTConfig.act = "gelu_erf"."""
    xf = x.astype(jnp.float32)
    return (0.5 * xf * (1.0 + jax.lax.erf(xf * INV_SQRT2))).astype(x.dtype)


def gelu_erf_grad_local(xf: jax.Array) -> jax.Array:
    """d gelu_erf(x)/dx in fp32: Φ(x) + x·φ(x)."""
    cdf = 0.5 * (1.0 + jax.lax.erf(xf * INV_SQRT2))
    pdf = INV_SQRT_2PI * jnp.exp(-0.5 * xf * xf)
    return cdf + xf * pdf


@jax.custom_vjp
def gelu_erf_cv(x: jax.Array) -> jax.Array:
    """erf-GELU with the same lean-stash VJP contract as gelu_cv: saves only
    x (own dtype), recomputes the analytic gradient in fp32."""
    return gelu_erf(x)


def _gelu_erf_cv_fwd(x):
    return gelu_erf(x), (x,)


def _gelu_erf_cv_bwd(res, dout):
    (x,) = res
    local = gelu_erf_grad_local(x.astype(jnp.float32))
    return ((local * dout.astype(jnp.float32)).astype(x.dtype),)


gelu_erf_cv.defvjp(_gelu_erf_cv_fwd, _gelu_erf_cv_bwd)


def linear(x: jax.Array, w: jax.Array, b: Optional[jax.Array] = None) -> jax.Array:
    """y = x @ W.T (+ b), W stored (OC, C) row-major — the reference matmul
    convention (rusty_vit.rs:484-498).  dot_general accumulates in fp32
    regardless of input dtype."""
    y = jax.lax.dot_general(
        x, w.astype(x.dtype),
        dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)
    if b is not None:
        y = y + b.astype(x.dtype)
    return y


def gelu(x: jax.Array) -> jax.Array:
    """tanh-approx GELU (rusty_vit.rs:614-623)."""
    s = jnp.sqrt(2.0 / jnp.pi).astype(x.dtype)
    cube = GELU_COEF * x * x * x
    return 0.5 * x * (1.0 + jnp.tanh(s * (x + cube)))


def attention_dense(qkv: jax.Array, num_heads: int, causal: bool = True,
                    quirks: bool = False, window: int = 0,
                    ) -> Tuple[jax.Array, jax.Array]:
    """Materialized multi-head attention over packed qkv (B,T,3C).

    The XLA analogue of rusty_vit.rs:512-563: Q|K|V packed along channels at
    offsets h*hs, h*hs+C, h*hs+2C — i.e. splitting into (B,T,NH,HS) per third.
    This is the reference path (parity tests, quirks mode, use_flash=False);
    the production path is ops/attention.fused_attention.

    quirks=True reproduces G5 (diagonal left unnormalized) and G11 (-1e4 max
    init).  Returns (out, att) where att is the stashed score matrix the
    reference keeps for its backward.
    """
    assert causal or not window, "sliding-window attention is causal-only"
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    scale = 1.0 / jnp.sqrt(jnp.array(HS, jnp.float32))
    q, k, v = jnp.split(qkv, 3, axis=-1)
    q = q.reshape(B, T, num_heads, HS).transpose(0, 2, 1, 3)
    k = k.reshape(B, T, num_heads, HS).transpose(0, 2, 1, 3)
    v = v.reshape(B, T, num_heads, HS).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    if causal:
        mask = jnp.tril(jnp.ones((T, T), bool))
        if window:
            # sliding window: query t sees keys in (t-window, t]
            mask = jnp.logical_and(mask, ~jnp.tril(
                jnp.ones((T, T), bool), k=-window))
        scores = jnp.where(mask, scores, -jnp.inf)
    m = jnp.max(scores, axis=-1, keepdims=True)
    if quirks:
        m = jnp.maximum(m, QUIRK_MAX_INIT)
    e = jnp.exp(scores - m)
    if causal:
        e = jnp.where(mask, e, 0.0)
    s = jnp.sum(e, axis=-1, keepdims=True)
    inv = jnp.where(s == 0.0, 0.0, 1.0 / s)   # expsum==0 guard, rusty_vit.rs:544
    att = e * inv
    if quirks and causal:
        # G5: normalization loop runs 0..t — token's own weight unnormalized
        eye = jnp.eye(T, dtype=bool)
        att = jnp.where(eye, e, att)
    out = jnp.einsum("bhqk,bhkd->bhqd", att.astype(v.dtype), v,
                     preferred_element_type=jnp.float32).astype(qkv.dtype)
    out = out.transpose(0, 2, 1, 3).reshape(B, T, C)
    return out, att


def softmax(logits: jax.Array, quirks: bool = False) -> jax.Array:
    """Row softmax with max subtraction (rusty_vit.rs:634-658)."""
    m = jnp.max(logits, axis=-1, keepdims=True)
    if quirks:
        m = jnp.maximum(m, QUIRK_MAX_INIT)
    e = jnp.exp(logits - m)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def cross_entropy_from_logits(logits: jax.Array, targets: jax.Array) -> jax.Array:
    """-log softmax(logits)[target], numerically fused (the production form of
    rusty_vit.rs:836-843 + softmax; backward is XLA's (p - onehot)/N which is
    exactly the llm.c crossentropy_softmax_backward the reference left
    undefined, gap G3)."""
    logits = logits.astype(jnp.float32)
    logz = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return logz - picked


# The weight-tied head is padded to a multiple of 128 rows (llm.c's
# padded_vocab_size: 50257 -> 50304); the vocab-parallel layouts shard it
# evenly over the padded rows.
VOCAB_PAD = 128
NEG_INF = -1e30


def pad_vocab(v: int) -> int:
    """Next multiple of VOCAB_PAD (50257 -> 50304)."""
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def cross_entropy_padded(logits: jax.Array, targets: jax.Array,
                         real_vocab: int) -> jax.Array:
    """CE over logits whose trailing axis is padded past `real_vocab`: the
    pad columns are masked out of the logsumexp (and so get zero gradient),
    which makes the loss equal to the unpadded CE over the real columns."""
    col = jnp.arange(logits.shape[-1])
    logits = jnp.where(col < real_vocab, logits.astype(jnp.float32), NEG_INF)
    return cross_entropy_from_logits(logits, targets)


def cross_entropy_smoothed(logits: jax.Array, targets: jax.Array,
                           smoothing: float = 0.1) -> jax.Array:
    """Label-smoothed CE: (1-s)·CE(target) + s·mean-over-classes CE — the
    standard ViT supervised-training loss."""
    logits = logits.astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    uniform = -jnp.mean(logp, axis=-1)
    return (1.0 - smoothing) * nll + smoothing * uniform


def cross_entropy_quirk(probs: jax.Array, targets: jax.Array) -> jax.Array:
    """G6: the reference negates the raw probability (no log)."""
    picked = jnp.take_along_axis(probs, targets[..., None], axis=-1)[..., 0]
    return -picked


def patchify(images: jax.Array, patch: int) -> jax.Array:
    """(B, H, W, C) -> (B, N, P*P*C) patch extraction as pure reshape/transpose.

    This is the 'patchify-as-strided-matmul' seam (BASELINE.json north star):
    the data movement is layout-only, and the following `linear` with the
    (C, P*P*C) patch-embed weight is one big matmul.  It fills the
    reference's undefined `encoder_forward` (gap G2, rusty_vit.rs:282) with
    vision semantics; its backward is the transposed matmul, not a scatter.
    """
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images.reshape(B, ph, patch, pw, patch, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)          # (B, ph, pw, P, P, C)
    return x.reshape(B, ph * pw, patch * patch * C)


def unpatchify(patches: jax.Array, patch: int, img_size: int, chans: int = 3) -> jax.Array:
    """Inverse of `patchify` — used by the MAE decoder reconstruction loss."""
    B, N, D = patches.shape
    ph = img_size // patch
    x = patches.reshape(B, ph, ph, patch, patch, chans)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(B, img_size, img_size, chans)
