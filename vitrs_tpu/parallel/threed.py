"""3-D parallelism: data x tensor x pipeline on one mesh.

Composes the verified building blocks: batch sharded over "data", attention
heads / MLP width column-row split over "model" (tensor_parallel._tp_block
with its explicit conjugate collectives), layers over "pipe" with GPipe
microbatching (pipeline's tick scan + ppermute hops).

Gradient combine rules, per leaf class:
  * block weights: sharded over (pipe, model) — local grads are the shard ✓
  * LN/bias leaves inside blocks: sharded over pipe, replicated over model —
    local grads full (plain-TP contract), no psum needed
  * encode/head/final-LN leaves: replicated everywhere, computed only on one
    stage — psum over "pipe"
  * everything: pmean over "data"
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..config import ViTConfig
from .. import params as PRM
from ..models import model as M
from ..ops import basic, optimizer as opt
from . import tensor_parallel as TPmod
from .tensor_parallel import (_tp_block, _tp_sp_block, to_tp_params,
                              from_tp_params, reduce_out, scatter_seq,
                              gather_seq_rep, SP_PARTIAL_GRADS,
                              _vp_gpt_encode, _vp_head_ce)


def make_mesh_3d(dp: int, tp: int, pp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:dp * tp * pp]
    assert len(devices) == dp * tp * pp
    return Mesh(np.asarray(devices).reshape(dp, tp, pp),
                axis_names=("data", "model", "pipe"))


def param_specs_3d(cfg: ViTConfig, vocab_parallel: bool = False):
    """TP-pytree leaves: block tensors pipe-sliced on L and model-sliced on
    their channel dim (per TP_BLOCK_SPECS); the rest replicated.
    vocab_parallel shards the padded wte over "model" (replicated on pipe —
    stage 0 embeds with it, stage S-1 runs the head with it)."""
    specs = {k: P() for k in PRM.tensor_order(cfg) if k not in M.BLOCK_KEYS}
    for k, tp_spec in TPmod.tp_block_specs(cfg).items():
        # the TP spec's first entry IS the stacked-L dim (None there);
        # the pipe axis takes it over
        specs[k] = P("pipe", *tuple(tp_spec)[1:])
    specs.pop("qkvw", None)
    specs.pop("qkvb", None)
    if vocab_parallel:
        specs["wte"] = P("model", None)
    return specs


def _loss_3d(p, inputs, labels, cfg: ViTConfig, n_stages: int,
             microbatches: int, sequence_parallel: bool = False,
             tp: int = 1, vocab_parallel: bool = False):
    """vit mode (patch-embed encode + classifier head) and gpt mode (token
    encode + weight-tied vocab head, per-token CE — the reference's own
    model, rusty_vit.rs:336-347) both pipeline over the same tick scan.

    vocab_parallel (gpt): the stage-0 embedding and the last stage's
    head+CE run the Megatron vocab-parallel forms (tensor_parallel.
    _vp_gpt_encode / _vp_head_ce) on the model-sharded padded wte — the
    full (Bm, T, V) logits tensor never materializes on the last stage
    (3.07 GB at GPT-2 B=32), and the head matmul stops running tp-times
    redundantly.  The collectives these forms contain live INSIDE the
    stage-gated lax.cond: every member of each model-axis psum group sits
    on the same pipe stage, so all participants take the branch together
    (verified fwd+grad on the CPU mesh before this landed)."""
    S, Mb = n_stages, microbatches
    stage = jax.lax.axis_index("pipe")
    gpt = cfg.mode == "gpt"
    B = inputs.shape[0]
    Bm = B // Mb
    micro_x = inputs.reshape((Mb, Bm) + inputs.shape[1:])
    micro_y = labels.reshape((Mb, Bm) + labels.shape[1:])
    layers_local = cfg.num_layers // S
    dtype = jnp.dtype(cfg.dtype)
    T = inputs.shape[1] if gpt else cfg.seq_len
    if sequence_parallel:
        assert T % tp == 0, (
            f"SP needs seq_len ({T}) divisible by tp ({tp}); "
            f"use pool='mean' or pad for CLS-token ViTs")
    T_act = T // tp if sequence_parallel else T
    perm = [(i, (i + 1) % S) for i in range(S)]

    def head_loss(y, lbl):
        if sequence_parallel:
            # exit the SP region: head runs replicated on the model axis
            y = gather_seq_rep(y, "model")
        lnf = basic.layernorm_cv(y, p["lnfw"], p["lnfb"])
        if gpt:
            if vocab_parallel:
                return _vp_head_ce(lnf.astype(dtype), p["wte"], lbl,
                                   "model", cfg.vocab_size)
            logits = basic.linear(lnf, p["wte"].astype(dtype), None)
            return jnp.mean(basic.cross_entropy_from_logits(logits, lbl))
        pooled = lnf[:, 0, :] if cfg.pool == "cls" else jnp.mean(lnf, axis=1)
        logits = basic.linear(pooled, p["headw"], p["headb"]).astype(jnp.float32)
        return jnp.mean(basic.cross_entropy_from_logits(logits, lbl))

    def encode(idx):
        xb = jax.lax.dynamic_index_in_dim(micro_x, idx, 0, keepdims=False)
        if gpt and vocab_parallel:
            h = _vp_gpt_encode(xb, p, cfg, "model", dtype)
        else:
            h = (M.gpt_encode(xb, p, dtype, rope=cfg.pos_emb == "rope")
                 if gpt else M.vit_encode(xb, p, cfg).astype(dtype))
        if sequence_parallel:
            # enter the SP region: each model-device keeps its T/tp shard —
            # the pipeline ppermute then moves 1/tp the bytes per hop too
            h = scatter_seq(h, "model", tp)
        return h

    def tick(carry, t):
        act, loss_sum = carry
        in_idx = jnp.clip(t, 0, Mb - 1)
        # cond (not select): only stage 0, on injection ticks, pays the
        # patch-embed FLOPs
        y = jax.lax.cond(
            jnp.logical_and(stage == 0, t < Mb),
            lambda a: encode(in_idx),
            lambda a: a, act)
        for l in range(layers_local):
            bp = {k: p[k][l] for k in TPmod.tp_block_specs(cfg)}
            if sequence_parallel:
                y = _tp_sp_block(y, bp, cfg, gpt, "model", tp)
            else:
                y = _tp_block(y, bp, cfg, gpt, "model")
        out_idx = t - (S - 1)
        lbl = jax.lax.dynamic_index_in_dim(
            micro_y, jnp.clip(out_idx, 0, Mb - 1), 0, keepdims=False)
        valid = jnp.logical_and(stage == S - 1,
                                jnp.logical_and(out_idx >= 0, out_idx < Mb))
        ml = jax.lax.cond(valid, head_loss,
                          lambda yy, ll: jnp.zeros((), jnp.float32), y, lbl)
        loss_sum = loss_sum + ml
        act = jax.lax.ppermute(y, "pipe", perm)
        return (act, loss_sum), None

    act0 = jnp.zeros((Bm, T_act, cfg.channels), dtype)
    (_, loss_sum), _ = jax.lax.scan(tick, (act0, jnp.zeros((), jnp.float32)),
                                    jnp.arange(Mb + S - 1))
    return reduce_out(loss_sum, "pipe") / Mb


def make_3d_train_step(cfg: ViTConfig, mesh: Mesh, microbatches: int,
                       sequence_parallel: bool = False,
                       vocab_parallel: bool = False,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """sequence_parallel=True runs every stage's blocks in the Megatron-SP
    form: the inter-stage activation (and its ppermute hop) is the
    (B, T/tp, C) sequence shard, LN/residual compute drops by 1/tp, and the
    TP collectives become the all-gather/reduce-scatter conjugate pair —
    the full 4-D composition dp x tp(sp) x pp on one mesh.

    vocab_parallel=True (gpt) adds the Megatron vocab-parallel embedding and
    head+CE over "model" (see _loss_3d) — wte shards over the padded vocab
    rows; its gradient stays per-model-shard-local (the vp contract) but is
    still psum'd over "pipe" (stage 0 embeds, stage S-1 runs the head)."""
    S = mesh.shape["pipe"]
    tp_size = mesh.shape["model"]
    assert cfg.num_layers % S == 0
    assert cfg.num_heads % tp_size == 0, (cfg.num_heads, tp_size)
    if cfg.is_gqa:
        assert cfg.kv_heads % tp_size == 0, (
            f"GQA under TP needs kv_heads ({cfg.kv_heads}) divisible by "
            f"the model-axis size ({tp_size})")
    if vocab_parallel:
        assert cfg.mode == "gpt", "vocab parallelism is the gpt head/CE path"
        assert basic.pad_vocab(cfg.vocab_size) % tp_size == 0
    specs = param_specs_3d(cfg, vocab_parallel)
    # leaves computed on one pipe stage only (embeddings/head/final-LN):
    # true grad = sum of per-stage partials — everything with no "pipe"
    # entry in its spec, INCLUDING the model-sharded vp wte
    pipe_partial = [k for k, s in specs.items()
                    if not any(e == "pipe" for e in tuple(s))]

    from . import gradops

    def spmd(p, m, v, images, labels, step, lr, wd):
        def lag(p_, x, y):
            loss_, grads_ = jax.value_and_grad(_loss_3d)(
                p_, x, y, cfg, S, microbatches, sequence_parallel, tp_size,
                vocab_parallel)
            for k in pipe_partial:  # encode/head computed on one stage only
                grads_[k] = jax.lax.psum(grads_[k], "pipe")
            if sequence_parallel:
                # LN/bias compute lives on sequence shards: partial grads
                # over the model axis (Megatron's SP LN-grad all-reduce)
                for k in SP_PARTIAL_GRADS:
                    grads_[k] = jax.lax.psum(grads_[k], "model")
            return loss_, grads_

        loss, grads = gradops.accumulate_microbatches(
            lag, p, images, labels, accum_steps)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            gnorm = gradops.global_grad_norm(grads, specs)
        if clip_norm > 0.0:
            scale = jnp.minimum(1.0, clip_norm / (gnorm + 1e-6))
            grads = {k: g * scale for k, g in grads.items()}
        p, m, v = opt.adamw_tree(p, grads, m, v, step, lr, weight_decay=wd)
        loss = jax.lax.pmean(loss, "data")
        if return_grad_norm:
            return p, m, v, loss, gnorm
        return p, m, v, loss

    out_tail = (P(), P()) if return_grad_norm else (P(),)
    mapped = shard_map(
        spmd, mesh=mesh,
        in_specs=(dict(specs), dict(specs), dict(specs), P("data"), P("data"),
                  P(), P(), P()),
        out_specs=(dict(specs), dict(specs), dict(specs)) + out_tail,
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def place_params_3d(params, cfg: ViTConfig, mesh: Mesh,
                    vocab_parallel: bool = False):
    tp_tree = to_tp_params(params, cfg, vocab_parallel)
    specs = param_specs_3d(cfg, vocab_parallel)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in tp_tree.items()}


def init_opt_state_3d(p3, mesh: Mesh, cfg: ViTConfig,
                      vocab_parallel: bool = False):
    specs = param_specs_3d(cfg, vocab_parallel)

    def zeros():
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, specs[k]))()
                for k, v in p3.items()}

    return zeros(), zeros()


# --- Adafactor under the 3-D mesh --------------------------------------------
#
# Block leaves are sharded (pipe, model): the pipe component is a LEADING-
# axis (stacked-L) slice the Adafactor step is exactly invariant to (the
# pipeline/EP argument), and the model component shards a TRAILING dim,
# completed with the gathered-stats pmeans of ops/adafactor.step
# (shard_axes/axis_name — the TP mechanism).  Composing both gives the
# single-device update on the full 3-D mesh.

def init_af_state_3d(p3, mesh: Mesh, cfg: ViTConfig,
                     vocab_parallel: bool = False, min_factor: int = 0):
    from ..ops import adafactor as AF
    from .pipeline import _af_specs_with_fac
    # factored layout judged on GLOBAL shapes; spec tree from the 3-D
    # specs; ndim-2 block stacks forced full-v (the pipe-slice invariance
    # rule, see threed_af_factored / pipeline.make_pp_train_step_adafactor)
    fac_global, gshapes = threed_af_factored(cfg, vocab_parallel, min_factor)
    sp = _af_specs_with_fac(gshapes, param_specs_3d(cfg, vocab_parallel),
                            fac_global)
    shapes = AF.AdafactorState(
        *({k: jax.ShapeDtypeStruct(_af_leaf_shape(f, k, p3[k].shape,
                                                  fac_global[k]), jnp.float32)
           for k in p3} for f in ("vr", "vc", "vf")), {})

    def place(tree, spt):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, spt[k]))()
                for k, v in tree.items()}

    return AF.AdafactorState(place(shapes.vr, sp.vr), place(shapes.vc, sp.vc),
                             place(shapes.vf, sp.vf), {})


def threed_af_factored(cfg: ViTConfig, vocab_parallel: bool = False,
                       min_factor: int = 0):
    """Per-leaf factored decision for 3-D Adafactor: GLOBAL TP-pytree
    shapes, with ndim-2 BLOCK stacks (LN/bias (L, C) leaves, which the pipe
    axis slices on L) forced full-v — rank-factoring across the stack axis
    both breaks the leading-slice invariance and is not meaningful
    structure."""
    from ..ops import adafactor as AF
    mf = min_factor or AF.MIN_FACTOR
    gshapes = TPmod.tp_global_shapes(cfg, vocab_parallel)
    block = set(TPmod.tp_block_specs(cfg))
    return ({k: AF._factored(v, mf) and not (v.ndim == 2 and k in block)
             for k, v in gshapes.items()}, gshapes)


def _af_leaf_shape(field: str, k: str, pshape, factored: bool):
    if factored:
        return {"vr": pshape[:-1], "vc": pshape[:-2] + pshape[-1:],
                "vf": ()}[field]
    return {"vr": (), "vc": (), "vf": pshape}[field]


def make_3d_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                 microbatches: int,
                                 sequence_parallel: bool = False,
                                 vocab_parallel: bool = False,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True,
                                 min_factor: int = 0):
    """(p3, af_state, inputs, labels, step, lr, wd) -> (p3, af_state, loss)
    on the dp x tp x pp mesh, Adafactor state sharded like the weights."""
    from ..ops import adafactor as AF
    S = mesh.shape["pipe"]
    tp_size = mesh.shape["model"]
    assert cfg.num_layers % S == 0
    assert cfg.num_heads % tp_size == 0, (cfg.num_heads, tp_size)
    if cfg.is_gqa:
        assert cfg.kv_heads % tp_size == 0
    if vocab_parallel:
        assert cfg.mode == "gpt"
        assert basic.pad_vocab(cfg.vocab_size) % tp_size == 0
    from .pipeline import _af_specs_with_fac
    specs = param_specs_3d(cfg, vocab_parallel)
    pipe_partial = [k for k, s in specs.items()
                    if not any(e == "pipe" for e in tuple(s))]
    fac, gshapes = threed_af_factored(cfg, vocab_parallel, min_factor)
    shard_axes = AF.shard_axes_from_specs(gshapes, specs, "model")
    stspec = _af_specs_with_fac(gshapes, specs, fac)

    def spmd(p, st, images, labels, step, lr, wd):
        loss, grads = jax.value_and_grad(_loss_3d)(p, images, labels, cfg, S,
                                                   microbatches,
                                                   sequence_parallel, tp_size,
                                                   vocab_parallel)
        for k in pipe_partial:
            grads[k] = jax.lax.psum(grads[k], "pipe")
        if sequence_parallel:
            for k in SP_PARTIAL_GRADS:
                grads[k] = jax.lax.psum(grads[k], "model")
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        mask = opt.decay_mask_2d(p) if weight_decay_2d_only else None
        p, st = AF.step(p, grads, st, step, lr, weight_decay=wd,
                        decay_mask=mask, relative_step=relative_step,
                        shard_axes=shard_axes, axis_name="model",
                        factored=fac)
        return p, st, jax.lax.pmean(loss, "data")

    mapped = shard_map(
        spmd, mesh=mesh,
        in_specs=(dict(specs), stspec, P("data"), P("data"), P(), P(), P()),
        out_specs=(dict(specs), stspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))
