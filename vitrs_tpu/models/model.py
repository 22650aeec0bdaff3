"""Pure-functional transformer forward — the redesign of the reference's
`ViT::forward` orchestration (rusty_vit.rs:269-351).

The reference walks a Rust `for l in 0..L` loop slicing per-layer views out of
stacked arenas (rusty_vit.rs:285-332).  Here the same stacked-leading-L layout
(params.py) feeds `jax.lax.scan`, so XLA compiles ONE block body reused L times
— compile time and code size stay O(1) in depth, and the whole model is a
single jit-compiled program.

Two modes (config.mode):
  gpt — token inputs, causal attention, weight-tied vocab head + softmax CE:
        the reference's actual semantics, used for parity testing.
  vit — patch-embedding encoder (the reference's undefined `encoder_forward`
        seam, gap G2), bidirectional attention (gap G14), CLS/mean-pool
        classifier head, label CE.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import ViTConfig
from ..ops import basic
from ..ops.attention import attention

BLOCK_KEYS = ("ln1w", "ln1b", "qkvw", "qkvb", "attprojw", "attprojb",
              "ln2w", "ln2b", "fcw", "fcb", "fcprojw", "fcprojb")


def _project_and_attend(ln1: jax.Array, p: Dict[str, jax.Array],
                        cfg: ViTConfig, causal: bool) -> jax.Array:
    """qkv projection + attention (ops/attention.py); autodiff gives the
    backward.  GQA projects the small (C + 2·kv_dim) packed width and the
    attention op takes K/V at kv_heads heads."""
    qkv = basic.linear(ln1, p["qkvw"], p["qkvb"])
    return attention(qkv, cfg.num_heads, causal=causal, quirks=cfg.quirks,
                     use_flash=cfg.use_flash, window=cfg.window,
                     rope=cfg.pos_emb == "rope", kv_heads=cfg.kv_heads)


def _drop_path(branch: jax.Array, key: jax.Array, rate: jax.Array
               ) -> jax.Array:
    """Stochastic depth: zero the residual branch for a random sample
    subset, rescaling survivors by 1/(1-rate) so expectation is preserved."""
    keep = jax.random.bernoulli(key, 1.0 - rate, (branch.shape[0], 1, 1))
    return jnp.where(keep, branch / (1.0 - rate), 0.0)


def _attn_residual(x: jax.Array, p: Dict[str, jax.Array], cfg: ViTConfig,
                   causal: bool, dp: bool) -> jax.Array:
    """x + drop_path(attproj(attention(qkv(ln1(x))))) — the first half of
    the 10-op block, shared by the dense and MoE block bodies."""
    with jax.named_scope("attn"):
        ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
        atty = _project_and_attend(ln1, p, cfg, causal)
        attproj = basic.linear(atty, p["attprojw"], p["attprojb"])
        if dp:
            attproj = _drop_path(attproj, p["_dp_key"][0], p["_dp_rate"])
        return x + attproj


def _block(x: jax.Array, p: Dict[str, jax.Array], cfg: ViTConfig,
           causal: bool) -> jax.Array:
    """The 10-op pre-LN block, exact op order of rusty_vit.rs:322-331.
    named_scope keeps the compiled HLO readable in profiles (SURVEY.md §5.1).

    When the scan leaves carry `_dp_rate`/`_dp_key` (train-time stochastic
    depth, see `transformer`), each residual branch is dropped per-sample."""
    dp = "_dp_rate" in p
    x = _attn_residual(x, p, cfg, causal, dp)
    with jax.named_scope("mlp"):
        ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
        fch = basic.linear(ln2, p["fcw"], p["fcb"])
        act = basic.gelu_erf_cv if cfg.act == "gelu_erf" else basic.gelu_cv
        fch_gelu = act(fch)
        fcproj = basic.linear(fch_gelu, p["fcprojw"], p["fcprojb"])
        if dp:
            fcproj = _drop_path(fcproj, p["_dp_key"][1], p["_dp_rate"])
        return x + fcproj


def _block_moe(x: jax.Array, p: Dict[str, jax.Array], cfg: ViTConfig,
               causal: bool, ep_axis=None, ep: int = 1):
    """The block with the dense MLP replaced by the MoE layer (ops/moe.py).
    Returns (x, aux) where aux is this layer's WEIGHTED router loss
    (cfg.moe_aux_weight · load_balance + cfg.moe_zloss_weight · z_loss).
    ep_axis/ep: expert-parallel mesh axis (inside shard_map) — the expert
    leaves of p arrive as local (L, E/ep, ...) shards."""
    from ..ops.moe import moe_mlp
    dp = "_dp_rate" in p
    x = _attn_residual(x, p, cfg, causal, dp)
    with jax.named_scope("moe"):
        ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
        out, aux = moe_mlp(ln2, p["routerw"], p["fcw"], p["fcb"],
                           p["fcprojw"], p["fcprojb"], top_k=cfg.moe_top_k,
                           cap_factor=cfg.moe_cap_factor,
                           erf=cfg.act == "gelu_erf",
                           ep_axis=ep_axis, ep=ep)
        if dp:
            out = _drop_path(out, p["_dp_key"][1], p["_dp_rate"])
        a = (cfg.moe_aux_weight * aux.load_balance
             + cfg.moe_zloss_weight * aux.z_loss)
        return x + out, a


def transformer(x: jax.Array, params: Dict[str, jax.Array], cfg: ViTConfig,
                causal: bool, rng: Optional[jax.Array] = None,
                return_aux: bool = False, ep_axis=None, ep: int = 1):
    """Scan the block over the stacked-L parameter slabs.

    rng != None and cfg.drop_path > 0 enables stochastic depth: layer l
    drops each residual branch with prob linspace(0, drop_path, L)[l]
    (timm's ViT recipe), keys folded per (layer, branch).

    return_aux=True additionally returns the mean per-layer weighted MoE
    router loss (a zero scalar for dense configs) — the loss functions add
    it to the CE objective.  Callers that only need activations (generation,
    feature extraction) leave it off; dropping aux is harmless outside
    training."""
    L = cfg.num_layers
    keys = BLOCK_KEYS + (("routerw",) if cfg.is_moe else ())
    blocks = {k: params[k] for k in keys}
    if rng is not None and cfg.drop_path > 0.0:
        blocks["_dp_rate"] = jnp.linspace(0.0, cfg.drop_path, L)
        blocks["_dp_key"] = jax.random.split(rng, 2 * L).reshape(L, 2, 2)
    unroll = True if cfg.scan_unroll == 0 else cfg.scan_unroll

    if cfg.is_moe:
        body = functools.partial(_block_moe, cfg=cfg, causal=causal,
                                 ep_axis=ep_axis, ep=ep)
        if cfg.remat == "full":
            body = jax.checkpoint(body)
        elif cfg.remat:
            # selective: lean attention branch + checkpointed MoE half
            from .selective import block_moe_selective
            body = functools.partial(block_moe_selective, cfg=cfg,
                                     causal=causal, ep_axis=ep_axis, ep=ep)

        def step_moe(carry, p):
            h, aux = carry
            h, a = body(h, p)
            return (h, aux + a), None

        (x, aux), _ = jax.lax.scan(
            step_moe, (x, jnp.zeros((), jnp.float32)), blocks, unroll=unroll)
        aux = aux / L
        return (x, aux) if return_aux else x

    body = functools.partial(_block, cfg=cfg, causal=causal)
    if cfg.remat == "full" or (cfg.remat and cfg.quirks):
        body = jax.checkpoint(body)  # blanket recompute (incl. attention)
    elif cfg.remat:
        # selective policy (models/selective.py): keep the attention output
        # and LN stats, recompute the qkv projection / MLP — the
        # reference's own stash choice (rusty_vit.rs:157-158, 601-602)
        from .selective import block_selective
        body = functools.partial(block_selective, cfg=cfg, causal=causal)

    def step(carry, p):
        return body(carry, p), None

    x, _ = jax.lax.scan(step, x, blocks, unroll=unroll)
    return (x, jnp.zeros((), jnp.float32)) if return_aux else x


# ---------------------------------------------------------------------------
# GPT-parity mode
# ---------------------------------------------------------------------------

def gpt_encode(tokens: jax.Array, params: Dict[str, jax.Array],
               dtype: jnp.dtype, rope: bool = False) -> jax.Array:
    """llm.c encoder semantics for the undefined `encoder_forward` (gap G2):
    wte lookup + learned positional embedding.  rope=True skips the wpe add
    (positions enter attention via the rotary path, ops/rope.py)."""
    if rope:
        return params["wte"][tokens].astype(dtype)
    T = tokens.shape[-1]
    return (params["wte"][tokens] + params["wpe"][None, :T, :]).astype(dtype)


def gpt_trunk(params: Dict[str, jax.Array], tokens: jax.Array,
              cfg: ViTConfig, return_aux: bool = False,
              ep_axis=None, ep: int = 1):
    """Everything up to (and including) the final layernorm; (B, T, C).
    return_aux adds the mean weighted MoE router loss (0.0 when dense)."""
    dtype = jnp.dtype(cfg.dtype)
    x = gpt_encode(tokens, params, dtype, rope=cfg.pos_emb == "rope")
    x = transformer(x, params, cfg, causal=True, return_aux=return_aux,
                    ep_axis=ep_axis, ep=ep)
    if return_aux:
        x, aux = x
        return basic.layernorm_cv(x, params["lnfw"], params["lnfb"]), aux
    return basic.layernorm_cv(x, params["lnfw"], params["lnfb"])


def gpt_forward(params: Dict[str, jax.Array], tokens: jax.Array,
                cfg: ViTConfig) -> jax.Array:
    """Returns logits (B, T, V).  Head is weight-tied to wte with no bias
    (rusty_vit.rs:336 passes an empty bias)."""
    lnf = gpt_trunk(params, tokens, cfg)
    return basic.linear(lnf, params["wte"].astype(lnf.dtype), None)


def gpt_loss(params: Dict[str, jax.Array], tokens: jax.Array,
             targets: jax.Array, cfg: ViTConfig,
             ep_axis=None, ep: int = 1) -> jax.Array:
    """Mean CE over B*T (rusty_vit.rs:342-347).  quirks=True uses the
    reference's literal -p loss (gap G6) for oracle parity.

    The weight-tied head is padded to basic.pad_vocab(V) rows (50257 ->
    50304, llm.c's own pad); the pad rows are zero, their logit columns are
    masked out of the logsumexp and get zero gradient, so the loss equals
    the unpadded CE in exact arithmetic.
    """
    if cfg.quirks:
        logits = gpt_forward(params, tokens, cfg)
        probs = basic.softmax(logits.astype(jnp.float32), quirks=True)
        return jnp.mean(basic.cross_entropy_quirk(probs, targets))
    V = cfg.vocab_size
    lnf, aux = gpt_trunk(params, tokens, cfg, return_aux=True,
                         ep_axis=ep_axis, ep=ep)
    with jax.named_scope("head_ce"):
        wte_p = jnp.pad(params["wte"].astype(lnf.dtype),
                        ((0, basic.pad_vocab(V) - V), (0, 0)))
        logits = basic.linear(lnf, wte_p, None)
        return jnp.mean(basic.cross_entropy_padded(logits, targets, V)) + aux


# ---------------------------------------------------------------------------
# ViT mode
# ---------------------------------------------------------------------------

def vit_encode(images: jax.Array, params: Dict[str, jax.Array],
               cfg: ViTConfig,
               keep_ids: Optional[jax.Array] = None) -> jax.Array:
    """Patch-embed encoder: patchify (layout-only) then ONE matmul, plus
    positional embedding and optional CLS token.

    keep_ids (B, K) selects a per-example subset of patches — the MAE masking
    hook (BASELINE.json configs[4]); gather happens *after* pos-embed add so
    position information survives masking.
    """
    dtype = jnp.dtype(cfg.dtype)
    patches = basic.patchify(images, cfg.patch_size)          # (B, N, P*P*C)
    x = basic.linear(patches.astype(dtype), params["patchw"].astype(dtype),
                     params["patchb"].astype(dtype))          # (B, N, C)
    n_prefix = 1 if cfg.pool == "cls" else 0
    x = x + params["wpe"][None, n_prefix:n_prefix + x.shape[1], :].astype(dtype)
    if keep_ids is not None:
        x = jnp.take_along_axis(x, keep_ids[..., None], axis=1)
    if cfg.pool == "cls":
        cls = (params["cls"] + params["wpe"][None, :1, :]).astype(dtype)
        x = jnp.concatenate([jnp.broadcast_to(cls, (x.shape[0], 1, x.shape[2])), x],
                            axis=1)
    return x


def vit_forward(params: Dict[str, jax.Array], images: jax.Array,
                cfg: ViTConfig,
                train: bool = False,
                rng: Optional[jax.Array] = None,
                return_aux: bool = False):
    """Returns class logits (B, num_classes); return_aux adds the mean
    weighted MoE router loss (0.0 for dense configs — V-MoE-style vision
    MoE rides the same ops/moe.py layer)."""
    x = vit_encode(images, params, cfg)
    dp_rng = head_rng = None
    if train and rng is not None:
        dp_rng, head_rng = jax.random.split(rng)
    x = transformer(x, params, cfg, causal=False, rng=dp_rng,
                    return_aux=return_aux)
    aux = None
    if return_aux:
        x, aux = x
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    if cfg.pool == "cls":
        pooled = lnf[:, 0, :]
    else:
        pooled = jnp.mean(lnf, axis=1)
    if train and cfg.drop_rate > 0.0 and head_rng is not None:
        keep = jax.random.bernoulli(head_rng, 1.0 - cfg.drop_rate,
                                    pooled.shape)
        pooled = jnp.where(keep, pooled / (1.0 - cfg.drop_rate), 0.0)
    logits = basic.linear(pooled, params["headw"],
                          params["headb"]).astype(jnp.float32)
    return (logits, aux) if return_aux else logits


def vit_loss(params: Dict[str, jax.Array], images: jax.Array,
             labels: jax.Array, cfg: ViTConfig,
             train: bool = True,
             rng: Optional[jax.Array] = None) -> jax.Array:
    logits, aux = vit_forward(params, images, cfg, train=train, rng=rng,
                              return_aux=True)
    if train and cfg.label_smoothing > 0.0:
        return jnp.mean(basic.cross_entropy_smoothed(logits, labels,
                                                     cfg.label_smoothing)) + aux
    return jnp.mean(basic.cross_entropy_from_logits(logits, labels)) + aux


def loss_fn(params, batch_inputs, batch_targets, cfg: ViTConfig,
            rng: Optional[jax.Array] = None) -> jax.Array:
    """Unified loss entry: dispatches on config mode."""
    if cfg.mode == "vit":
        return vit_loss(params, batch_inputs, batch_targets, cfg, rng=rng)
    return gpt_loss(params, batch_inputs, batch_targets, cfg)


def forward_with_loss(params, batch_inputs, batch_targets, cfg: ViTConfig):
    """ONE compiled program returning (logits, mean_loss) — the reference's
    forward contract populates probs AND mean_loss in a single pass
    (rusty_vit.rs:269-350); computing them as two jit programs doubles the
    device work for the flat API."""
    if cfg.mode == "vit":
        logits = vit_forward(params, batch_inputs, cfg, train=False)
        loss = jnp.mean(basic.cross_entropy_from_logits(logits, batch_targets))
        return logits, loss
    logits = gpt_forward(params, batch_inputs, cfg)
    if cfg.quirks:
        probs = basic.softmax(logits.astype(jnp.float32), quirks=True)
        loss = jnp.mean(basic.cross_entropy_quirk(probs, batch_targets))
    else:
        loss = jnp.mean(basic.cross_entropy_from_logits(logits, batch_targets))
    return logits, loss
