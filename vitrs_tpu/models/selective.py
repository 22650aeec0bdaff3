"""Selective activation rematerialization.

A blanket `jax.checkpoint(body)` recomputes EVERYTHING in backward.  The
reference's own stash choice is the blueprint for what to keep instead: it
saves the attention output and the LN statistics (att at
rusty_vit.rs:157-158, mean/rstd at rusty_vit.rs:601-602) and recomputes the
rest.  The two branches here implement that policy:

  attention branch: `jax.checkpoint` with a policy that saves only the
                    attention output and the LN statistics; the backward
                    recomputes ln1, the qkv projection and the attention
                    forward (whose softmax statistics the attention
                    backward needs)
  MLP branch:       a hand-written VJP that saves (x, mean, rstd) and
                    recomputes ln2, fch and GELU

so the per-layer activation footprint drops from ~15 (B,T,C)-equivalents
(plain path) to ~3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from ..config import ViTConfig
from ..ops import basic
from ..ops.attention import attention, expand_packed

ATTN_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb")
MLP_KEYS = ("ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")

_ATTN_SAVED = jax.checkpoint_policies.save_only_these_names(
    "attn_out", "ln_stats")


def _norm_from_stats(x, w, b, mean, rstd):
    """Recompute the LN output from saved fp32 statistics (one pass)."""
    xf = x.astype(jnp.float32)
    out = (xf - mean[..., None]) * rstd[..., None] * w.astype(jnp.float32) \
        + b.astype(jnp.float32)
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# attention branch: x -> attproj(attention(qkv_proj(ln1(x))))
# ---------------------------------------------------------------------------

def _attn_ref(x, ln1w, ln1b, qkvw, qkvb, attprojw, attprojb, num_heads,
              causal, kv_heads=0, rope=False, window=0):
    """Dense pure-jnp branch (the gradient oracle in tests)."""
    ln1, _, _ = basic.layernorm(x, ln1w, ln1b)
    qkv = basic.linear(ln1, qkvw, qkvb)
    if rope:
        from ..ops.attention import split_gqa
        from ..ops.rope import rope_qk
        q, k, v = split_gqa(qkv, num_heads, kv_heads or num_heads)
        q, k = rope_qk(q, k, jnp.arange(x.shape[1]), num_heads, kv_heads)
        qkv = jnp.concatenate([q, k, v], axis=-1)
    qkv = expand_packed(qkv, num_heads, kv_heads)
    out, _ = basic.attention_dense(qkv, num_heads, causal=causal,
                                   window=window)
    return basic.linear(out, attprojw, attprojb)


def _attn_body(x, ln1w, ln1b, qkvw, qkvb, attprojw, attprojb, *,
               num_heads, causal, allow_flash, kv_heads, rope, window):
    _, mean, rstd = basic.layernorm(x, ln1w, ln1b)
    mean = checkpoint_name(mean, "ln_stats")
    rstd = checkpoint_name(rstd, "ln_stats")
    ln1 = _norm_from_stats(x, ln1w, ln1b, mean, rstd)
    qkv = basic.linear(ln1, qkvw, qkvb)
    atty = attention(qkv, num_heads, causal=causal, use_flash=allow_flash,
                     window=window, rope=rope, kv_heads=kv_heads)
    atty = checkpoint_name(atty, "attn_out")
    return basic.linear(atty, attprojw, attprojb)


def attn_branch(x, ln1w, ln1b, qkvw, qkvb, attprojw, attprojb,
                num_heads, causal, allow_flash=True, kv_heads=0,
                rope=False, window=0):
    """The pre-LN attention residual branch with lean saved state.
    allow_flash=False (cfg.use_flash) takes the dense reference attention —
    the same contract as model._project_and_attend.  kv_heads (0 = MHA)
    selects GQA/MQA (a C + 2*kv_dim wide projection); rope rotates q/k
    inside the attention op."""
    body = functools.partial(_attn_body, num_heads=num_heads, causal=causal,
                             allow_flash=allow_flash, kv_heads=kv_heads,
                             rope=rope, window=window)
    return jax.checkpoint(body, policy=_ATTN_SAVED)(
        x, ln1w, ln1b, qkvw, qkvb, attprojw, attprojb)


# ---------------------------------------------------------------------------
# MLP branch: x -> fcproj(gelu(fc(ln2(x))))
# ---------------------------------------------------------------------------

def _mlp_impl(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf):
    _, mean, rstd = basic.layernorm(x, ln2w, ln2b)
    ln2 = _norm_from_stats(x, ln2w, ln2b, mean, rstd)
    h = basic.linear(ln2, fcw, fcb)
    hg = basic.gelu_erf(h) if erf else basic.gelu(h)
    out = basic.linear(hg, fcprojw, fcprojb)
    return out, mean, rstd


@functools.partial(jax.custom_vjp, nondiff_argnums=(7,))
def mlp_branch(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf=False):
    """The pre-LN MLP residual branch; saves only (x, mean, rstd) and
    recomputes fch/GELU in backward (the reference never stashed GELU
    intermediates either — gelu_backward recomputes from fch,
    rusty_vit.rs:793-807).  erf selects exact GELU (cfg.act="gelu_erf")."""
    out, _, _ = _mlp_impl(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf)
    return out


def _mlp_branch_fwd(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf):
    out, mean, rstd = _mlp_impl(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb, erf)
    return out, (x, ln2w, ln2b, fcw, fcb, fcprojw, mean, rstd)


def _mlp_branch_bwd(erf, res, db):
    x, ln2w, ln2b, fcw, fcb, fcprojw, mean, rstd = res
    C = x.shape[-1]
    ln2 = _norm_from_stats(x, ln2w, ln2b, mean, rstd)
    h = basic.linear(ln2, fcw, fcb)
    hf = h.astype(jnp.float32)
    hg = basic.gelu_erf(h) if erf else basic.gelu(h)

    df = db.astype(jnp.float32)
    dhg = basic.linear(db, fcprojw.T)
    dfcprojw = jax.lax.dot_general(
        df.reshape(-1, C), hg.reshape(-1, hg.shape[-1]).astype(jnp.float32),
        (((0,), (0,)), ((), ()))).astype(fcprojw.dtype)
    dfcprojb = jnp.sum(df, axis=tuple(range(db.ndim - 1))
                       ).astype(fcprojw.dtype)

    grad_local = (basic.gelu_erf_grad_local if erf
                  else basic.gelu_grad_local)
    dh = (grad_local(hf) * dhg.astype(jnp.float32)).astype(h.dtype)
    dln2 = basic.linear(dh, fcw.T)
    dfcw = jax.lax.dot_general(
        dh.reshape(-1, dh.shape[-1]).astype(jnp.float32),
        ln2.reshape(-1, C).astype(jnp.float32),
        (((0,), (0,)), ((), ()))).astype(fcw.dtype)
    dfcb = jnp.sum(dh.astype(jnp.float32), axis=tuple(range(dh.ndim - 1))
                   ).astype(fcw.dtype)

    dx, dln2w, dln2b = basic.layernorm_bwd_from_stats(x, ln2w, mean, rstd,
                                                      dln2)
    return dx, dln2w, dln2b, dfcw, dfcb, dfcprojw, dfcprojb


mlp_branch.defvjp(_mlp_branch_fwd, _mlp_branch_bwd)


# ---------------------------------------------------------------------------
# block assembly (drop-path composed OUTSIDE the branches, like models/model)
# ---------------------------------------------------------------------------

def block_moe_selective(x, p, cfg: ViTConfig, causal: bool, ep_axis=None,
                        ep: int = 1):
    """MoE block under the selective policy: the attention residual uses
    the lean branch (attention output + LN stats saved); the MoE half is
    wrapped in `jax.checkpoint` — its
    dispatch buffers and expert activations (the E·cap·4C hidden, ~10
    (B,T,C)-equivalents per layer at top-2/1.25x) are recomputed in
    backward instead of stashed.  Returns (x, weighted_aux) like
    model._block_moe."""
    from .model import _drop_path
    dp = "_dp_rate" in p
    with jax.named_scope("attn"):
        a = attn_branch(x, p["ln1w"], p["ln1b"], p["qkvw"], p["qkvb"],
                        p["attprojw"], p["attprojb"], cfg.num_heads, causal,
                        cfg.use_flash, cfg.kv_heads,
                        cfg.pos_emb == "rope", cfg.window)
        if dp:
            a = _drop_path(a, p["_dp_key"][0], p["_dp_rate"])
        x = x + a

    def moe_half(x_, ln2w, ln2b, routerw, fcw, fcb, fcprojw, fcprojb):
        from ..ops.moe import moe_mlp
        ln2 = basic.layernorm_cv(x_, ln2w, ln2b)
        out, aux = moe_mlp(ln2, routerw, fcw, fcb, fcprojw, fcprojb,
                           top_k=cfg.moe_top_k,
                           cap_factor=cfg.moe_cap_factor,
                           erf=cfg.act == "gelu_erf",
                           ep_axis=ep_axis, ep=ep)
        w = (cfg.moe_aux_weight * aux.load_balance
             + cfg.moe_zloss_weight * aux.z_loss)
        return out, w

    with jax.named_scope("moe"):
        out, aw = jax.checkpoint(moe_half)(
            x, p["ln2w"], p["ln2b"], p["routerw"], p["fcw"], p["fcb"],
            p["fcprojw"], p["fcprojb"])
        if dp:
            out = _drop_path(out, p["_dp_key"][1], p["_dp_rate"])
    return x + out, aw


def block_selective(x, p, cfg: ViTConfig, causal: bool):
    """The 10-op block (rusty_vit.rs:322-331) with lean-residual branches.
    Semantically identical to model._block; used when cfg.remat is truthy
    and not 'full'."""
    from .model import _drop_path
    dp = "_dp_rate" in p
    with jax.named_scope("attn"):
        a = attn_branch(x, p["ln1w"], p["ln1b"], p["qkvw"], p["qkvb"],
                        p["attprojw"], p["attprojb"], cfg.num_heads, causal,
                        cfg.use_flash, cfg.kv_heads,
                        cfg.pos_emb == "rope", cfg.window)
        if dp:
            a = _drop_path(a, p["_dp_key"][0], p["_dp_rate"])
        x = x + a
    with jax.named_scope("mlp"):
        b = mlp_branch(x, p["ln2w"], p["ln2b"], p["fcw"], p["fcb"],
                       p["fcprojw"], p["fcprojb"], cfg.act == "gelu_erf")
        if dp:
            b = _drop_path(b, p["_dp_key"][1], p["_dp_rate"])
        return x + b
