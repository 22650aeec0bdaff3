"""Tensor parallelism (Megatron-style) over a 2-D (data, model) mesh.

Beyond the reference's capability set (SURVEY.md §2 row 26 marks TP as out of
scope for parity) — provided as the scale-out path for models past one card's
memory.  The classic column/row-parallel decomposition, written with shard_map
so every collective is explicit:

  attn:  qkv  = x · Wqkv_colᵀ      heads sharded over "model" (column)
         out  = psum(atty · Wproj_rowᵀ)                        (row)
  mlp:   fch  = gelu(x · Wfc_colᵀ)  4C sharded                 (column)
         out  = psum(fch · Wproj_rowᵀ)                         (row)

with the conjugate collectives for autodiff: `copy_in` (identity forward,
psum-over-model backward) guards each parallel branch's input so replicated
tensors receive full gradients; the forward psum's transpose is the identity
broadcast.  LN/embeddings/head stay replicated; weight grads of sharded
tensors are naturally the local shard of the full gradient.

Weight layout: the canonical stacked tensors are passed through shard_map
in_specs that slice their output/input channel dims — qkvw reshaped
(L, 3, C, C) so each model shard owns a *head-aligned* slice of Q, K and V
(a raw 3C-row slice would mix the packed thirds).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..config import ViTConfig
from .. import params as PRM
from ..models import model as M
from ..ops import basic, optimizer as opt


def make_mesh_2d(dp: int, tp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:dp * tp]
    assert len(devices) == dp * tp, (len(devices), dp, tp)
    return Mesh(np.asarray(devices).reshape(dp, tp), axis_names=("data",
                                                                 "model"))


# --- conjugate collectives for Megatron autodiff ---------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def copy_in(x, axis):
    """identity forward; psum over `axis` backward — marks the entry of a
    model-parallel branch so replicated inputs get full gradients."""
    return x


def _copy_in_fwd(x, axis):
    return x, None


def _copy_in_bwd(axis, _, g):
    return (jax.lax.psum(g, axis),)


copy_in.defvjp(_copy_in_fwd, _copy_in_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def reduce_out(x, axis):
    """psum forward (combine row-parallel partials); IDENTITY backward —
    the summed output's cotangent is already the correct per-partial
    cotangent.  (Under shard_map check_rep=False JAX transposes psum to
    psum, which would scale every upstream gradient by the model-axis size —
    measured 2x at tp=2 — so the conjugate must be explicit.)"""
    return jax.lax.psum(x, axis)


def _reduce_out_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _reduce_out_bwd(axis, _, g):
    return (g,)


reduce_out.defvjp(_reduce_out_fwd, _reduce_out_bwd)


# --- sequence-parallel conjugates (Megatron-SP) -----------------------------
#
# With SP, the residual stream between blocks is sharded over the *sequence*
# dim on the model axis: LayerNorm/residual compute and memory drop by 1/tp,
# and the psum of the row-parallel matmuls becomes reduce-scatter while the
# column-parallel input gather becomes all-gather — the same total collective
# volume as plain TP (RS + AG = all-reduce), less redundant elementwise work.

def _ag(x, axis):
    g = jax.lax.all_gather(x, axis, axis=0, tiled=False)   # (tp, B, Ts, ...)
    return jnp.moveaxis(g, 0, 1).reshape(
        (x.shape[0], g.shape[0] * x.shape[1]) + x.shape[2:])


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def gather_seq(x, axis, tp):
    """all-gather the sequence shards (axis 1) forward, REDUCE-SCATTER
    backward — the Megatron `g` operator.  The gathered tensor feeds
    model-PARALLEL consumers (each device computes only its heads / 4C
    slice), so every device's cotangent is a partial: the true per-shard
    cotangent is sum-over-devices then slice."""
    return _ag(x, axis)


def _gather_seq_fwd(x, axis, tp):
    return _ag(x, axis), None


def _gather_seq_bwd(axis, tp, _, ct):
    return (_rs(ct, axis, tp),)


gather_seq.defvjp(_gather_seq_fwd, _gather_seq_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def gather_seq_rep(x, axis):
    """all-gather forward for a REPLICATED continuation (the exit of the SP
    region: final LN + head run redundantly on every device).  Each device's
    cotangent is already the full gradient, so backward is slice-own — a
    psum here would over-count by tp."""
    return _ag(x, axis)


def _gather_seq_rep_fwd(x, axis):
    return _ag(x, axis), (x.shape[1],)


def _gather_seq_rep_bwd(axis, res, ct):
    (ts,) = res
    idx = jax.lax.axis_index(axis)
    return (jax.lax.dynamic_slice_in_dim(ct, idx * ts, ts, axis=1),)


gather_seq_rep.defvjp(_gather_seq_rep_fwd, _gather_seq_rep_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def scatter_seq_sum(x, axis, tp):
    """reduce-scatter over the sequence dim forward (combine row-parallel
    partials AND shard the result); backward all-gathers the cotangent."""
    return _rs(x, axis, tp)


def _rs(x, axis, tp):
    B, T = x.shape[0], x.shape[1]
    parts = x.reshape((B, tp, T // tp) + x.shape[2:])
    parts = jnp.moveaxis(parts, 1, 0)                      # (tp, B, Ts, ...)
    return jax.lax.psum_scatter(parts, axis, scatter_dimension=0,
                                tiled=False)[...]


def _scatter_seq_sum_fwd(x, axis, tp):
    return _rs(x, axis, tp), None


def _scatter_seq_sum_bwd(axis, tp, _, ct):
    return (_ag(ct, axis),)


scatter_seq_sum.defvjp(_scatter_seq_sum_fwd, _scatter_seq_sum_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def scatter_seq(x, axis, tp):
    """Enter the SP region: take this device's sequence shard of a replicated
    tensor forward; backward all-gathers the shard cotangents so every device
    leaves with the FULL upstream gradient (keeps replicated-parameter grads
    full-by-construction, same contract as plain TP)."""
    return _slice_own(x, axis, tp)


def _slice_own(x, axis, tp):
    ts = x.shape[1] // tp
    idx = jax.lax.axis_index(axis)
    return jax.lax.dynamic_slice_in_dim(x, idx * ts, ts, axis=1)


def _scatter_seq_fwd(x, axis, tp):
    return _slice_own(x, axis, tp), None


def _scatter_seq_bwd(axis, tp, _, ct):
    return (_ag(ct, axis),)


scatter_seq.defvjp(_scatter_seq_fwd, _scatter_seq_bwd)


def _tp_qkv(ln1, p, cfg: ViTConfig):
    """Local q/k/v from the shard's projection leaves, UNROTATED.  MHA:
    head-aligned thirds of qkv3w.  GQA: separate qw/kw/vw leaves, each
    column-sharded on its own head dim; each device owns WHOLE query groups
    (tp | kv_heads and head blocks are contiguous), so the K/V expansion is
    shard-local.  rope is applied by M.attention — the rotation is
    identical per head, so the shard's contiguous
    head slice rotates exactly like the full tensor, and it commutes with
    the K/V group expansion (ln1 carries the FULL sequence in both TP
    variants: plain TP is replicated on T; SP gathers before the
    projection, so kernel positions 0..T-1 are the true positions)."""
    D = cfg.head_size
    if "qw" in p:                         # GQA leaves (to_tp_params)
        from ..ops.attention import expand_kv_heads
        q = basic.linear(ln1, p["qw"], p["qb"])
        k = basic.linear(ln1, p["kw"], p["kb"])
        v = basic.linear(ln1, p["vw"], p["vb"])
        heads_local = q.shape[-1] // D
        kvh_local = k.shape[-1] // D
        return (q, expand_kv_heads(k, kvh_local, heads_local),
                expand_kv_heads(v, kvh_local, heads_local), heads_local)
    q = basic.linear(ln1, p["qkv3w"][0], p["qkv3b"][0])
    k = basic.linear(ln1, p["qkv3w"][1], p["qkv3b"][1])
    v = basic.linear(ln1, p["qkv3w"][2], p["qkv3b"][2])
    heads_local = q.shape[-1] // D
    return q, k, v, heads_local


def _tp_sp_block(x_s, p, cfg: ViTConfig, causal: bool, axis: str, tp: int):
    """Sequence-parallel variant: x_s is the (B, T/tp, C) residual shard."""
    with jax.named_scope("attn_tp_sp"):
        ln1_s = basic.layernorm_cv(x_s, p["ln1w"], p["ln1b"])
        ln1 = gather_seq(ln1_s, axis, tp)                   # (B, T, C)
        q, k, v, heads_local = _tp_qkv(ln1, p, cfg)
        qkv_local = jnp.concatenate([q, k, v], axis=-1)
        atty = M.attention(qkv_local, heads_local, causal=causal,
                           quirks=False, use_flash=cfg.use_flash,
                           window=cfg.window, rope=cfg.pos_emb == "rope")
        attproj_s = scatter_seq_sum(
            basic.linear(atty, p["attprojw"], None), axis, tp) + p["attprojb"]
        x_s = x_s + attproj_s.astype(x_s.dtype)
    with jax.named_scope("mlp_tp_sp"):
        ln2_s = basic.layernorm_cv(x_s, p["ln2w"], p["ln2b"])
        ln2 = gather_seq(ln2_s, axis, tp)
        fch_gelu = basic.gelu_cv(basic.linear(ln2, p["fcw"], p["fcb"]))
        fcproj_s = scatter_seq_sum(
            basic.linear(fch_gelu, p["fcprojw"], None), axis, tp) + p["fcprojb"]
        return x_s + fcproj_s.astype(x_s.dtype)


# --- vocab parallelism (Megatron VocabParallelEmbedding + parallel CE) ------
#
# Without it, the final-LN → head matmul → cross-entropy tail runs
# REDUNDANTLY on every model shard: at GPT-2 the (B·T, C)×(C, 50304) head is
# ~1/6 of forward FLOPs and the (B, T, V) logits are the largest activation
# in the program (3.07 GB at B=32 — the top allocation in the OOM report
# that motivated this).  Vocab parallelism shards the weight-tied wte table
# over the PADDED vocab rows (basic.pad_vocab → Vp % tp == 0), so each
# device computes only its (B, T, Vp/tp) logits slice and the full softmax
# statistics are assembled from two scalar-field collectives:
#
#   embedding:  e = psum_m( in_shard(tokens) · wte_local[tokens - v0] )
#   head/CE:    m  = pmax_m(max_v logits_local)        (stop-gradient: the
#               z  = psum_m(Σ_v exp(logits_local - m))  max shift cancels in
#               t  = psum_m(in_shard(tgt) · logit_tgt)  ∂(log z + m − t))
#               loss = mean(log z + m − t)
#
# `reduce_out` (psum fwd / identity bwd) is the right conjugate for z and t —
# their downstream consumers are replicated; `copy_in` guards lnf entering
# the column-parallel head so its partial (vocab-slice) cotangents are
# psum'd.  wte gradients are per-shard-local by construction (embedding rows
# via the masked scatter-add transpose, head rows via dlogitsᵀ·lnf), so the
# train step applies AdamW to them unsummed, like every sharded leaf.

def _vp_gpt_encode(tokens, p, cfg: ViTConfig, axis: str, dtype):
    """gpt_encode (models/model.py:200-208 semantics) with wte sharded
    (Vp/tp, C) over `axis`.  Out-of-shard lookups contribute exact zeros, so
    the psum reproduces the replicated lookup bitwise."""
    wte_l = p["wte"]
    Vl = wte_l.shape[0]
    v0 = jax.lax.axis_index(axis) * Vl
    loc = jnp.clip(tokens - v0, 0, Vl - 1)
    in_shard = ((tokens >= v0) & (tokens < v0 + Vl))[..., None]
    emb = reduce_out(jnp.where(in_shard, wte_l[loc], 0), axis)
    if cfg.pos_emb == "rope":
        return emb.astype(dtype)
    T = tokens.shape[-1]
    return (emb + p["wpe"][None, :T, :]).astype(dtype)


def _vp_head_ce(lnf, wte_l, targets, axis: str, V: int):
    """Weight-tied head matmul on the local vocab shard + parallel CE.
    Matches jnp.mean(cross_entropy_from_logits(lnf·wteᵀ, targets)) (the
    gpt_loss tail, models/model.py:270-272) without ever materializing the
    full (B, T, V) logits on any device.  Pad rows (zero weights, possibly
    whole shards when Vp/tp ≥ V − v0) are masked to −inf and contribute
    exp(−inf)=0 to z and zero gradient."""
    Vl = wte_l.shape[0]
    v0 = jax.lax.axis_index(axis) * Vl
    lnf_c = copy_in(lnf, axis)                      # bwd: psum partial dlnf
    logits = basic.linear(lnf_c, wte_l.astype(lnf.dtype), None)
    lg = logits.astype(jnp.float32)
    col = v0 + jnp.arange(Vl)
    lg = jnp.where(col[None, None, :] < V, lg, -jnp.inf)
    m_loc = jnp.max(lg, axis=-1)
    m_glob = jax.lax.pmax(jax.lax.stop_gradient(m_loc), axis)   # (B, T)
    z = reduce_out(jnp.sum(jnp.exp(lg - m_glob[..., None]), axis=-1), axis)
    t_loc = jnp.take_along_axis(
        lg, jnp.clip(targets - v0, 0, Vl - 1)[..., None], axis=-1)[..., 0]
    in_shard = (targets >= v0) & (targets < v0 + Vl)
    t = reduce_out(jnp.where(in_shard, t_loc, 0.0), axis)
    return jnp.mean(jnp.log(z) + m_glob - t)


# --- the tensor-parallel block ----------------------------------------------

def _tp_block(x, p, cfg: ViTConfig, causal: bool, axis: str):
    """The 10-op block with column/row-parallel matmuls.  p's sharded leaves
    arrive pre-sliced by shard_map:
      qkv3w (3, C/tp, C), qkv3b (3, C/tp), attprojw (C, C/tp),
      fcw (4C/tp, C), fcb (4C/tp), fcprojw (C, 4C/tp);
    LN params and biases-after-psum replicated."""
    with jax.named_scope("attn_tp"):
        ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
        ln1 = copy_in(ln1, axis)
        q, k, v, heads_local = _tp_qkv(ln1, p, cfg)
        qkv_local = jnp.concatenate([q, k, v], axis=-1)   # (B,T,3*C/tp)
        atty = M.attention(qkv_local, heads_local, causal=causal,
                           quirks=False, use_flash=cfg.use_flash,
                           window=cfg.window, rope=cfg.pos_emb == "rope")
        attproj = reduce_out(
            basic.linear(atty, p["attprojw"], None), axis) + p["attprojb"]
        x = x + attproj.astype(x.dtype)
    with jax.named_scope("mlp_tp"):
        ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
        ln2 = copy_in(ln2, axis)
        fch_gelu = basic.gelu_cv(basic.linear(ln2, p["fcw"], p["fcb"]))
        fcproj = reduce_out(
            basic.linear(fch_gelu, p["fcprojw"], None), axis) + p["fcprojb"]
        return x + fcproj.astype(x.dtype)


# leaves whose forward compute runs on sequence shards under SP — their
# per-device gradients cover only T/tp rows and must be psum'd over "model"
SP_PARTIAL_GRADS = ("ln1w", "ln1b", "ln2w", "ln2b", "attprojb", "fcprojb")

TP_BLOCK_SPECS = {
    "ln1w": P(), "ln1b": P(),
    "qkv3w": P(None, None, "model", None),   # (L, 3, C, C) col-parallel
    "qkv3b": P(None, None, "model"),
    "attprojw": P(None, None, "model"),      # (L, C, C) row-parallel (C_in)
    "attprojb": P(),
    "ln2w": P(), "ln2b": P(),
    "fcw": P(None, "model", None),           # (L, 4C, C) col-parallel
    "fcb": P(None, "model"),
    "fcprojw": P(None, None, "model"),       # (L, C, 4C) row-parallel (4C in)
    "fcprojb": P(),
}


def to_tp_params(params, cfg: ViTConfig, vocab_parallel: bool = False):
    """Canonical pytree -> TP pytree.  MHA: qkvw/qkvb reshaped (L, 3, C, C)
    so the model axis slices head-aligned parts instead of raw packed rows.
    GQA: the packed projection splits into separate qw/kw/vw leaves, each
    column-sharded on its own (different-sized) head dimension.
    vocab_parallel pads wte to (pad_vocab(V), C) so the model axis slices
    even vocab-row shards."""
    out = dict(params)
    L, C = cfg.num_layers, cfg.channels
    if vocab_parallel:
        V = cfg.vocab_size
        Vp = basic.pad_vocab(V)
        out["wte"] = jnp.pad(params["wte"], ((0, Vp - V), (0, 0)))
    if cfg.is_gqa:
        kvd = cfg.kv_dim
        w, b = params["qkvw"], params["qkvb"]
        out["qw"], out["qb"] = w[:, :C], b[:, :C]
        out["kw"], out["kb"] = w[:, C:C + kvd], b[:, C:C + kvd]
        out["vw"], out["vb"] = w[:, C + kvd:], b[:, C + kvd:]
    else:
        out["qkv3w"] = params["qkvw"].reshape(L, 3, C, C)
        out["qkv3b"] = params["qkvb"].reshape(L, 3, C)
    del out["qkvw"], out["qkvb"]
    return out


def from_tp_params(tp_params, cfg: ViTConfig, vocab_parallel: bool = False):
    out = dict(tp_params)
    L, C = cfg.num_layers, cfg.channels
    if vocab_parallel:
        out["wte"] = tp_params["wte"][:cfg.vocab_size]
    if cfg.is_gqa:
        out["qkvw"] = jnp.concatenate(
            [tp_params["qw"], tp_params["kw"], tp_params["vw"]], axis=1)
        out["qkvb"] = jnp.concatenate(
            [tp_params["qb"], tp_params["kb"], tp_params["vb"]], axis=1)
        for k in ("qw", "qb", "kw", "kb", "vw", "vb"):
            del out[k]
    else:
        out["qkvw"] = tp_params["qkv3w"].reshape(L, 3 * C, C)
        out["qkvb"] = tp_params["qkv3b"].reshape(L, 3 * C)
        del out["qkv3w"], out["qkv3b"]
    return out


def tp_block_specs(cfg: ViTConfig):
    """Block-leaf PartitionSpecs for this config's TP pytree layout."""
    specs = dict(TP_BLOCK_SPECS)
    if cfg.is_gqa:
        del specs["qkv3w"], specs["qkv3b"]
        for k in ("qw", "kw", "vw"):
            specs[k] = P(None, "model", None)
        for k in ("qb", "kb", "vb"):
            specs[k] = P(None, "model")
    return specs


def tp_param_specs(cfg: ViTConfig, vocab_parallel: bool = False):
    """PartitionSpec per TP-pytree leaf (replicated for non-block tensors)."""
    specs = {k: P() for k in PRM.tensor_order(cfg)
             if k not in M.BLOCK_KEYS}
    specs.update(tp_block_specs(cfg))
    specs.pop("qkvw", None)
    specs.pop("qkvb", None)
    if vocab_parallel:
        specs["wte"] = P("model", None)      # padded vocab rows sharded
    return specs


def _tp_forward(x_or_tokens, p, cfg: ViTConfig, axis: str,
                sequence_parallel: bool = False, tp: int = 1,
                vocab_parallel: bool = False):
    dtype = jnp.dtype(cfg.dtype)
    if cfg.mode == "vit":
        h = M.vit_encode(x_or_tokens, p, cfg)
        causal = False
    elif vocab_parallel:
        h = _vp_gpt_encode(x_or_tokens, p, cfg, axis, dtype)
        causal = True
    else:
        h = M.gpt_encode(x_or_tokens, p, dtype,
                         rope=cfg.pos_emb == "rope")
        causal = True
    if sequence_parallel:
        assert h.shape[1] % tp == 0, (
            f"sequence parallelism needs seq_len ({h.shape[1]}) divisible by "
            f"tp ({tp}); use pool='mean' or pad for CLS-token ViTs")
        h = scatter_seq(h, axis, tp)
        for l in range(cfg.num_layers):
            bp = {k: p[k][l] for k in tp_block_specs(cfg)}
            h = _tp_sp_block(h, bp, cfg, causal, axis, tp)
        h = gather_seq_rep(h, axis)
    else:
        for l in range(cfg.num_layers):
            bp = {k: p[k][l] for k in tp_block_specs(cfg)}
            h = _tp_block(h, bp, cfg, causal, axis)
    lnf = basic.layernorm_cv(h, p["lnfw"], p["lnfb"])
    if cfg.mode == "vit":
        pooled = lnf[:, 0, :] if cfg.pool == "cls" else jnp.mean(lnf, axis=1)
        return basic.linear(pooled, p["headw"], p["headb"]).astype(jnp.float32)
    if vocab_parallel:
        return lnf                      # head+CE fuse in tp_loss (_vp_head_ce)
    return basic.linear(lnf, p["wte"].astype(dtype), None)


def tp_loss(p, inputs, targets, cfg: ViTConfig, axis: str = "model",
            sequence_parallel: bool = False, tp: int = 1,
            vocab_parallel: bool = False):
    out = _tp_forward(inputs, p, cfg, axis, sequence_parallel, tp,
                      vocab_parallel)
    if vocab_parallel:
        return _vp_head_ce(out, p["wte"], targets, axis, cfg.vocab_size)
    return jnp.mean(basic.cross_entropy_from_logits(out, targets))


def make_tp_train_step(cfg: ViTConfig, mesh: Mesh,
                       sequence_parallel: bool = False,
                       vocab_parallel: bool = False,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """2-D SPMD train step: batch sharded over "data", block weights sharded
    over "model", AdamW state sharded like the weights.

    Signature: (tp_params, m, v, inputs, targets, step, lr, wd)
            -> (tp_params, m, v, loss[, grad_norm])
    accum_steps/clip_norm/return_grad_norm carry the native DP path's
    production-training semantics (parallel/gradops.py) onto the TP mesh:
    micro-batch accumulation before the data combine, global-norm clip after
    it, pre-clip norm reported.
    """
    assert not cfg.is_moe, (
        "MoE under TP is not wired (the TP block is dense-MLP-sharded) — "
        "use dp/ep (parallel/expert_parallel.py)")
    specs = tp_param_specs(cfg, vocab_parallel)
    param_spec_tree = dict(specs)
    tp_size = mesh.shape["model"]
    assert cfg.num_heads % tp_size == 0, (cfg.num_heads, tp_size)
    if cfg.is_gqa:
        assert cfg.kv_heads % tp_size == 0, (
            f"GQA under TP needs kv_heads ({cfg.kv_heads}) divisible by the "
            f"model-axis size ({tp_size}) so each shard owns whole groups")
    if vocab_parallel:
        assert cfg.mode == "gpt", "vocab parallelism is the gpt head/CE path"
        Vp = basic.pad_vocab(cfg.vocab_size)
        assert Vp % tp_size == 0, (Vp, tp_size)

    from . import gradops

    def spmd(p, m, v, inputs, targets, step, lr, wd):
        def lag(p_, x, y):
            loss_, grads_ = jax.value_and_grad(tp_loss)(
                p_, x, y, cfg, "model", sequence_parallel, tp_size,
                vocab_parallel)
            if sequence_parallel:
                # params whose compute lives on sequence shards produce
                # partial grads — sum them over the model axis (Megatron's
                # SP LN-grad all-reduce)
                grads_ = dict(grads_)
                for k in SP_PARTIAL_GRADS:
                    grads_[k] = jax.lax.psum(grads_[k], "model")
            return loss_, grads_

        loss, grads = gradops.accumulate_microbatches(
            lag, p, inputs, targets, accum_steps)
        # combine over data; model-axis grads are already correct per shard
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            gnorm = gradops.global_grad_norm(grads, specs)
        if clip_norm > 0.0:
            scale = jnp.minimum(1.0, clip_norm / (gnorm + 1e-6))
            grads = {k: g * scale for k, g in grads.items()}
        p, m, v = opt.adamw_tree(p, grads, m, v, step, lr, weight_decay=wd)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "data"), "model")
        if return_grad_norm:
            return p, m, v, loss, gnorm
        return p, m, v, loss

    out_tail = (P(), P()) if return_grad_norm else (P(),)
    mapped = shard_map(
        spmd, mesh=mesh,
        in_specs=(param_spec_tree, param_spec_tree, param_spec_tree,
                  P("data"), P("data"), P(), P(), P()),
        out_specs=(param_spec_tree, param_spec_tree, param_spec_tree)
                  + out_tail,
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def place_tp_params(params, cfg: ViTConfig, mesh: Mesh,
                    vocab_parallel: bool = False):
    """Canonical params -> TP layout, device_put with the TP shardings."""
    tp = to_tp_params(params, cfg, vocab_parallel)
    specs = tp_param_specs(cfg, vocab_parallel)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in tp.items()}


def init_tp_opt_state(tp_params, mesh: Mesh, cfg: ViTConfig,
                      vocab_parallel: bool = False):
    specs = tp_param_specs(cfg, vocab_parallel)

    def zeros():
        # distinct buffers per tree — m and v must not alias (donation)
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, specs[k]))()
                for k, v in tp_params.items()}

    return zeros(), zeros()


# --- Adafactor under TP ------------------------------------------------------
#
# The open sharded-dim factoring question (a TP-sharded matrix's row/col
# g² stats and RMS scalars cross the model axis) is resolved with GATHERED
# semantics: ops/adafactor.step(shard_axes=..., axis_name="model") completes
# every cross-shard mean with a pmean of equal-sized partial means, so the
# update equals the single-device Adafactor step exactly (up to reduction
# order) — pinned by tests/test_adafactor.py::test_tp_adafactor_parity.
# State memory shards with the params: vr/vc slices live on the shard that
# owns their rows/cols (ops/adafactor.state_specs).

def tp_global_shapes(cfg: ViTConfig, vocab_parallel: bool = False):
    """GLOBAL TP-pytree leaf shapes (ShapeDtypeStructs) — inside shard_map
    the leaves are local slices, but the Adafactor factored/full layout and
    shard_axes map must be judged on the full dims (shared by the TP and
    3-D Adafactor factories)."""
    from ..params import param_shapes
    shapes = param_shapes(cfg)
    L, C = cfg.num_layers, cfg.channels
    gshapes = {k: jax.ShapeDtypeStruct(s, jnp.float32)
               for k, s in shapes.items()}
    if vocab_parallel:
        gshapes["wte"] = jax.ShapeDtypeStruct(
            (basic.pad_vocab(cfg.vocab_size), C), jnp.float32)
    if cfg.is_gqa:
        kvd = cfg.kv_dim
        gshapes["qw"] = jax.ShapeDtypeStruct((L, C, C), jnp.float32)
        gshapes["qb"] = jax.ShapeDtypeStruct((L, C), jnp.float32)
        for k, oc in (("kw", kvd), ("vw", kvd)):
            gshapes[k] = jax.ShapeDtypeStruct((L, oc, C), jnp.float32)
            gshapes[k.replace("w", "b")] = jax.ShapeDtypeStruct(
                (L, oc), jnp.float32)
        for k in ("qkvw", "qkvb"):
            del gshapes[k]
    else:
        gshapes["qkv3w"] = jax.ShapeDtypeStruct((L, 3, C, C), jnp.float32)
        gshapes["qkv3b"] = jax.ShapeDtypeStruct((L, 3, C), jnp.float32)
        del gshapes["qkvw"], gshapes["qkvb"]
    return gshapes


def init_tp_af_state(tp_params, mesh: Mesh, cfg: ViTConfig,
                     vocab_parallel: bool = False, min_factor: int = 0):
    from ..ops import adafactor as AF
    mf = min_factor or AF.MIN_FACTOR
    shapes = jax.eval_shape(
        lambda p: AF.init_state(p, min_factor=mf), tp_params)
    sp = AF.state_specs(tp_params, tp_param_specs(cfg, vocab_parallel), mf)

    def place(tree, spt):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, spt[k]))()
                for k, v in tree.items()}

    return AF.AdafactorState(place(shapes.vr, sp.vr), place(shapes.vc, sp.vc),
                             place(shapes.vf, sp.vf), {})


def make_tp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                 sequence_parallel: bool = False,
                                 vocab_parallel: bool = False,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True,
                                 min_factor: int = 0):
    """2-D SPMD train step with Adafactor state sharded like the weights.

    Signature: (tp_params, af_state, inputs, targets, step, lr, wd)
            -> (tp_params, af_state, loss)
    """
    from ..ops import adafactor as AF
    from ..params import param_shapes
    assert not cfg.is_moe, "MoE: use dp/ep (make_ep_train_step_adafactor)"
    specs = tp_param_specs(cfg, vocab_parallel)
    tp_size = mesh.shape["model"]
    assert cfg.num_heads % tp_size == 0, (cfg.num_heads, tp_size)
    if cfg.is_gqa:
        assert cfg.kv_heads % tp_size == 0, (cfg.kv_heads, tp_size)
    if vocab_parallel:
        assert cfg.mode == "gpt", "vocab parallelism is the gpt head/CE path"
        assert basic.pad_vocab(cfg.vocab_size) % tp_size == 0

    gshapes = tp_global_shapes(cfg, vocab_parallel)
    mf = min_factor or AF.MIN_FACTOR
    shard_axes = AF.shard_axes_from_specs(gshapes, specs, "model")
    stspec = AF.state_specs(gshapes, specs, mf)

    def spmd(p, st, inputs, targets, step, lr, wd):
        loss, grads = jax.value_and_grad(tp_loss)(p, inputs, targets, cfg,
                                                  "model", sequence_parallel,
                                                  tp_size, vocab_parallel)
        if sequence_parallel:
            for k in SP_PARTIAL_GRADS:
                grads[k] = jax.lax.psum(grads[k], "model")
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        mask = opt.decay_mask_2d(p) if weight_decay_2d_only else None
        # the factored/full layout is judged on GLOBAL shapes: a leaf whose
        # local slice falls under MIN_FACTOR (C/tp < 128) must still factor
        # exactly as the single-device step would
        fac = {k: AF._factored(v, mf) for k, v in gshapes.items()}
        p, st = AF.step(p, grads, st, step, lr, weight_decay=wd,
                        decay_mask=mask, relative_step=relative_step,
                        shard_axes=shard_axes, axis_name="model",
                        factored=fac)
        return p, st, jax.lax.pmean(jax.lax.pmean(loss, "data"), "model")

    pspec = dict(specs)
    mapped = shard_map(
        spmd, mesh=mesh,
        in_specs=(pspec, stspec, P("data"), P("data"), P(), P(), P()),
        out_specs=(pspec, stspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))
