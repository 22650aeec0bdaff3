"""Expert parallelism — MoE expert shards over a mesh axis.

The reference is single-threaded and dense (SURVEY.md §2 rows 26-27); MoE
(ops/moe.py) is the beyond-reference sparse-scaling axis, and this module is
its scale-out story:

  * mesh ("data", "expert"): the batch is sharded over BOTH axes (every
    device is a data worker), expert weights are sharded over "expert" only
    — device (d, e) holds experts [e·E/ep, (e+1)·E/ep) and is replicated
    across the data rows;
  * inside the jitted step the MoE layer makes one `all_to_all` hop out over
    the "expert" axis (each device ships the capacity slots bound for peers'
    experts and receives every peer's slots for its own) and one hop home —
    the GShard dispatch pattern;
  * routing itself (the (S, E) router matmul + top-k + slot cumsum) stays
    local to each device — only the dispatched activations move;
  * gradients: `jax.grad` differentiates straight through the all_to_all
    pair (its transpose is the reverse all_to_all).  Expert-shard grads are
    completed with a psum over "data" (each data row contributed its own
    tokens); replicated-tensor grads psum over both axes;
  * optimizer: tree-form AdamW (ops/optimizer.adamw_tree) with m/v sharded
    exactly like the parameters — expert moments never materialize
    unsharded, so optimizer memory for the expert slabs also scales 1/ep.

Gradient parity vs the single-device MoE model is exact when no assignment
drops (capacity ≥ local demand); with drops the two legitimately differ —
capacity is computed over each device's LOCAL token set (tests/test_moe.py
pins the no-drop parity).

Two semantics are intentionally LOCAL per device (both standard distributed-
MoE practice, both covered by the parity test's aux_weight=0 mode):
  * the load-balance aux loss balances each device's own token set (it is
    quadratic in the token distribution, so the mean of per-shard values
    differs slightly from the global-batch value — the Switch/GShard
    formulation is likewise computed per dispatch group);
  * capacity: each device drops against its own cap = ceil(S_loc·K/E·f).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..config import ViTConfig
from ..models import model as M
from ..ops import basic, optimizer as opt

# parameter leaves carrying a (L, E, ...) expert axis (params.param_shapes)
EXPERT_KEYS = ("fcw", "fcb", "fcprojw", "fcprojb")


def make_mesh_dp_ep(dp: int, ep: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:dp * ep]
    return Mesh(np.asarray(devices).reshape(dp, ep),
                axis_names=("data", "expert"))


def ep_param_specs(cfg: ViTConfig):
    """PartitionSpec per tensor: expert slabs sharded on their E axis (dim 1
    after the stacked-L dim), everything else replicated."""
    from ..params import param_shapes
    assert cfg.is_moe
    return {name: (P(None, "expert") if name in EXPERT_KEYS else P())
            for name in param_shapes(cfg)}


def place_ep_params(params, cfg: ViTConfig, mesh: Mesh):
    specs = ep_param_specs(cfg)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in params.items()}


def init_ep_opt_state(params, cfg: ViTConfig, mesh: Mesh):
    """Tree-form AdamW moments, sharded like the parameters (fp32)."""
    specs = ep_param_specs(cfg)

    def zeros(k, p):
        return jax.jit(
            lambda: jnp.zeros(p.shape, jnp.float32),
            out_shardings=NamedSharding(mesh, specs[k]))()

    m = {k: zeros(k, p) for k, p in params.items()}
    v = {k: zeros(k, p) for k, p in params.items()}
    return m, v


def make_ep_train_step(cfg: ViTConfig, mesh: Mesh,
                       weight_decay_2d_only: bool = True,
                       accum_steps: int = 1, clip_norm: float = 0.0,
                       return_grad_norm: bool = False):
    """Jitted dp×ep SPMD training step for a MoE GPT config.

    Signature: (params, m, v, inputs, targets, step, lr, wd)
            -> (params, m, v, loss[, grad_norm])
    with the expert slabs (and their m/v) sharded over "expert", everything
    else replicated, and the batch sharded over (data, expert) jointly.
    accum_steps/clip_norm carry the DP path's production semantics
    (parallel/gradops.py); note micro-batching a MoE step routes each
    micro-batch at its own capacity, the standard accumulation semantics.
    """
    assert cfg.is_moe and cfg.mode == "gpt", "EP serves MoE gpt configs"
    ep = mesh.shape["expert"]
    assert cfg.num_experts % ep == 0, (cfg.num_experts, ep)
    specs = ep_param_specs(cfg)
    from . import gradops

    def spmd_step(params, m, v, inputs, targets, step, lr, wd):
        def lag(p_, x, y):
            def global_loss(p):
                local = M.gpt_loss(p, x, y, cfg, ep_axis="expert", ep=ep)
                return jax.lax.pmean(local, ("data", "expert"))

            loss_, grads_ = jax.value_and_grad(global_loss)(p_)
            # complete the per-device grads.  JAX's collective-transpose
            # convention (transpose(psum) = psum) means grad-of-pmean
            # delivers each device an UNSCALED cotangent: the raw grad of a
            # leaf is the sum of dl_dev/dleaf over every device its copy
            # served, with NO 1/N.  Summing over the axes the leaf is
            # replicated on (expert shards: "data" only — each shard is a
            # distinct logical param per "expert" index; everything else:
            # both axes) and dividing once by mesh.size reassembles
            # d(global mean loss)/dleaf exactly — pinned against the
            # single-device gradient in tests/test_moe.py.
            inv = 1.0 / mesh.size
            return loss_, {
                k: jax.lax.psum(g, ("data",) if k in EXPERT_KEYS
                                else ("data", "expert")) * inv
                for k, g in grads_.items()}

        loss, grads = gradops.accumulate_microbatches(
            lag, params, inputs, targets, accum_steps)
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            gnorm = gradops.global_grad_norm(grads, specs)
        if clip_norm > 0.0:
            scale = jnp.minimum(1.0, clip_norm / (gnorm + 1e-6))
            grads = {k: g * scale for k, g in grads.items()}
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, m, v = opt.adamw_tree(params, grads, m, v, step, lr,
                                      weight_decay=wd, decay_mask=mask)
        if return_grad_norm:
            return params, m, v, loss, gnorm
        return params, m, v, loss

    pspec = {k: specs[k] for k in specs}
    out_tail = (P(), P()) if return_grad_norm else (P(),)
    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(pspec, pspec, pspec, P(("data", "expert")),
                  P(("data", "expert")), P(), P(), P()),
        out_specs=(pspec, pspec, pspec) + out_tail,
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def shard_batch(batch, mesh: Mesh):
    """Leading dim sharded jointly over (data, expert)."""
    return jax.device_put(batch, NamedSharding(mesh, P(("data", "expert"))))


# --- Adafactor under EP ------------------------------------------------------
#
# The natural pairing: MoE expert slabs are the parameter bulk (~E× the dense
# MLP), so their optimizer state is the first memory wall EP hits.  Adafactor
# (ops/adafactor.py) is exactly leading-axis-sharding-invariant by
# construction — factored stats and RMS scalars live per trailing matrix
# (weights) / per trailing vector (bias stacks, full elementwise v), and the
# expert axis is a leading batch dim of every expert leaf — so each device
# running the plain AF.step on its LOCAL (L, E/ep, ...) shard reproduces the
# single-device update for its experts bit-for-bit given the same grads
# (pinned by tests/test_moe.py::test_ep_adafactor_parity_vs_single_device).

def af_state_specs(params, cfg: ViTConfig):
    """PartitionSpecs for an AdafactorState mirroring ep_param_specs (vr
    drops the last param dim, vc the second-to-last, full-v/momentum shard
    like the param) — the generic rule in ops/adafactor.state_specs."""
    from ..ops import adafactor as AF
    return AF.state_specs(params, ep_param_specs(cfg))


def init_ep_af_state(params, cfg: ViTConfig, mesh: Mesh):
    """Adafactor state sharded like the parameters.  Zeros are created
    DIRECTLY in the sharded layout (jit with out_shardings, the same pattern
    as init_ep_opt_state) — the full-v bias stacks scale with E, so the state
    never materializes unsharded on any single device."""
    from ..ops import adafactor as AF
    shapes = jax.eval_shape(AF.init_state, params)
    sp = af_state_specs(params, cfg)

    def place(tree, spt):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, spt[k]))()
                for k, v in tree.items()}

    return AF.AdafactorState(place(shapes.vr, sp.vr), place(shapes.vc, sp.vc),
                             place(shapes.vf, sp.vf), {})


def make_ep_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                 weight_decay_2d_only: bool = True):
    """dp×ep training step with Adafactor state sharded over "expert".

    Signature: (params, af_state, inputs, targets, step, lr, wd)
            -> (params, af_state, loss)
    """
    from ..ops import adafactor as AF
    assert cfg.is_moe and cfg.mode == "gpt", "EP serves MoE gpt configs"
    ep = mesh.shape["expert"]
    assert cfg.num_experts % ep == 0, (cfg.num_experts, ep)
    specs = ep_param_specs(cfg)

    def spmd_step(params, st, inputs, targets, step, lr, wd):
        def global_loss(p):
            local = M.gpt_loss(p, inputs, targets, cfg,
                               ep_axis="expert", ep=ep)
            return jax.lax.pmean(local, ("data", "expert"))

        loss, grads = jax.value_and_grad(global_loss)(params)
        # same grad completion as the AdamW step (see make_ep_train_step)
        inv = 1.0 / mesh.size
        grads = {k: jax.lax.psum(g, ("data",) if k in EXPERT_KEYS
                                 else ("data", "expert")) * inv
                 for k, g in grads.items()}
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, st = AF.step(params, grads, st, step, lr, weight_decay=wd,
                             decay_mask=mask)
        return params, st, loss

    # dummy params only to enumerate leaves/ndims for the state spec tree
    from ..params import param_shapes
    shapes = param_shapes(cfg)
    stspec = af_state_specs(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
        cfg)
    pspec = {k: specs[k] for k in specs}
    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(pspec, stspec, P(("data", "expert")),
                  P(("data", "expert")), P(), P(), P()),
        out_specs=(pspec, stspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))


# --- EP x TP: experts over "expert", attention/per-expert FFN over "model" --
#
# GShard's actual deployment shape (dp x ep caps the expert count at the
# data-axis size and leaves TP's activation-memory relief off the MoE
# table).  One (data, expert, model) mesh:
#   * tokens shard over (data, expert) jointly — every device is a data
#     worker, exactly like dp x ep; the model axis holds TP "replicas" of
#     each cell's token set;
#   * attention runs the verified Megatron block (tensor_parallel._tp_qkv +
#     copy_in/reduce_out conjugates) over "model";
#   * expert slabs shard over BOTH axes: fcw (L, E/ep, 4C/tp, C),
#     fcb (L, E/ep, 4C/tp), fcprojw (L, E/ep, C, 4C/tp) — each expert's
#     FFN is column/row-split inside its "expert" home (ops/moe._expert_ffn
#     tp_axis);
#   * routing (router matmul, top-k, slot cumsum, scatter) is replicated on
#     "model" — deterministic, so every model shard computes identical
#     dst/weight and the all_to_all over "expert" stays per-model-column.
#
# Gradient completion is the dp x ep rule verbatim (psum over "data" for
# expert leaves, ("data", "expert") otherwise, x 1/n_cells where
# n_cells = dp·ep): the TP conjugates make every leaf's model-axis gradient
# exact WITHIN a cell, so the model axis never needs a psum — sharded
# leaves' grads are their slice, model-replicated leaves (LN, biases after
# reduce_out, fcprojb) already hold the full cell contribution.

def make_mesh_dp_ep_tp(dp: int, ep: int, tp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:dp * ep * tp]
    assert len(devices) == dp * ep * tp
    return Mesh(np.asarray(devices).reshape(dp, ep, tp),
                axis_names=("data", "expert", "model"))


def ep_tp_param_specs(cfg: ViTConfig, vocab_parallel: bool = False):
    """TP specs for the attention half (head-aligned qkv3w etc.), expert
    slabs sharded (expert, model), router/embeddings/LN replicated.
    vocab_parallel shards the padded wte over "model" (the Megatron
    vocab-parallel embedding + head/CE — for MoE-at-scale the full
    (B, T, V) logits tensor was the top allocation in the B=32 OOM)."""
    from . import tensor_parallel as TPmod
    assert cfg.is_moe
    specs = TPmod.tp_param_specs(cfg, vocab_parallel)  # dense fcw overridden
    specs["routerw"] = P()
    specs["fcw"] = P(None, "expert", "model", None)
    specs["fcb"] = P(None, "expert", "model")
    specs["fcprojw"] = P(None, "expert", None, "model")
    specs["fcprojb"] = P(None, "expert")
    return specs


def to_ep_tp_params(params, cfg: ViTConfig, vocab_parallel: bool = False):
    """Canonical -> EP x TP pytree (the TP qkv head-aligned reshape; expert
    slabs keep their canonical (L, E, ...) layout — sharding slices them)."""
    from . import tensor_parallel as TPmod
    return TPmod.to_tp_params(params, cfg, vocab_parallel)


def from_ep_tp_params(tp_params, cfg: ViTConfig, vocab_parallel: bool = False):
    from . import tensor_parallel as TPmod
    return TPmod.from_tp_params(tp_params, cfg, vocab_parallel)


def place_ep_tp_params(params, cfg: ViTConfig, mesh: Mesh,
                       vocab_parallel: bool = False):
    t = to_ep_tp_params(params, cfg, vocab_parallel)
    specs = ep_tp_param_specs(cfg, vocab_parallel)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in t.items()}


def init_ep_tp_opt_state(ep_tp_params, cfg: ViTConfig, mesh: Mesh,
                         vocab_parallel: bool = False):
    specs = ep_tp_param_specs(cfg, vocab_parallel)

    def zeros():
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, specs[k]))()
                for k, v in ep_tp_params.items()}

    return zeros(), zeros()


def _ep_tp_block(x, bp, cfg: ViTConfig, ep: int):
    """TP attention half + EP x TP MoE half; returns (x, weighted_aux)."""
    from ..ops.moe import moe_mlp
    from . import tensor_parallel as TPmod
    with jax.named_scope("attn_ep_tp"):
        ln1 = basic.layernorm_cv(x, bp["ln1w"], bp["ln1b"])
        ln1 = TPmod.copy_in(ln1, "model")
        q, k, v, heads_local = TPmod._tp_qkv(ln1, bp, cfg)
        qkv_local = jnp.concatenate([q, k, v], axis=-1)
        atty = M.attention(qkv_local, heads_local, causal=True, quirks=False,
                           use_flash=cfg.use_flash, window=cfg.window,
                           rope=cfg.pos_emb == "rope")
        attproj = TPmod.reduce_out(
            basic.linear(atty, bp["attprojw"], None), "model") + bp["attprojb"]
        x = x + attproj.astype(x.dtype)
    with jax.named_scope("moe_ep_tp"):
        ln2 = basic.layernorm_cv(x, bp["ln2w"], bp["ln2b"])
        out, aux = moe_mlp(ln2, bp["routerw"], bp["fcw"], bp["fcb"],
                           bp["fcprojw"], bp["fcprojb"],
                           top_k=cfg.moe_top_k,
                           cap_factor=cfg.moe_cap_factor,
                           erf=cfg.act == "gelu_erf",
                           ep_axis="expert", ep=ep, tp_axis="model")
        a = (cfg.moe_aux_weight * aux.load_balance
             + cfg.moe_zloss_weight * aux.z_loss)
        return x + out.astype(x.dtype), a


def _ep_tp_loss(p, tokens, targets, cfg: ViTConfig, ep: int,
                vocab_parallel: bool = False):
    from . import tensor_parallel as TPmod
    dtype = jnp.dtype(cfg.dtype)
    if vocab_parallel:
        h = TPmod._vp_gpt_encode(tokens, p, cfg, "model", dtype)
    else:
        h = M.gpt_encode(tokens, p, dtype, rope=cfg.pos_emb == "rope")
    block_keys = ["ln1w", "ln1b", "attprojw", "attprojb",
                  "ln2w", "ln2b", "routerw", "fcw", "fcb",
                  "fcprojw", "fcprojb"]
    block_keys += (["qw", "qb", "kw", "kb", "vw", "vb"] if cfg.is_gqa
                   else ["qkv3w", "qkv3b"])
    aux = jnp.zeros((), jnp.float32)
    for l in range(cfg.num_layers):
        bp = {k: p[k][l] for k in block_keys}
        h, a = _ep_tp_block(h, bp, cfg, ep)
        aux = aux + a
    lnf = basic.layernorm_cv(h, p["lnfw"], p["lnfb"])
    if vocab_parallel:
        # Megatron parallel head+CE over "model": the (B, T, V) logits —
        # the top allocation in the MoE B=32 OOM report — never exist
        ce = TPmod._vp_head_ce(lnf.astype(dtype), p["wte"], targets,
                               "model", cfg.vocab_size)
        return ce + aux / cfg.num_layers
    logits = basic.linear(lnf, p["wte"].astype(dtype), None)
    ce = jnp.mean(basic.cross_entropy_from_logits(logits, targets))
    return ce + aux / cfg.num_layers


def make_ep_tp_train_step(cfg: ViTConfig, mesh: Mesh,
                          weight_decay_2d_only: bool = True,
                          vocab_parallel: bool = False):
    """Jitted dp x ep x tp SPMD training step for a MoE GPT config.

    Signature: (ep_tp_params, m, v, inputs, targets, step, lr, wd)
            -> (ep_tp_params, m, v, loss)

    vocab_parallel: the Megatron vocab-parallel embedding + head/CE over
    "model" (wte sharded over padded vocab rows; grads per-shard-local —
    the same contract as the flat-TP and 3-D variants)."""
    assert cfg.is_moe and cfg.mode == "gpt", "EP x TP serves MoE gpt configs"
    ep = mesh.shape["expert"]
    tp = mesh.shape["model"]
    assert cfg.num_experts % ep == 0, (cfg.num_experts, ep)
    assert cfg.num_heads % tp == 0, (cfg.num_heads, tp)
    assert (4 * cfg.channels) % tp == 0
    if cfg.is_gqa:
        assert cfg.kv_heads % tp == 0, (cfg.kv_heads, tp)
    if vocab_parallel:
        assert basic.pad_vocab(cfg.vocab_size) % tp == 0
    specs = ep_tp_param_specs(cfg, vocab_parallel)
    n_cells = mesh.shape["data"] * ep

    def spmd_step(params, m, v, inputs, targets, step, lr, wd):
        def global_loss(pa):
            local = _ep_tp_loss(pa, inputs, targets, cfg, ep,
                                vocab_parallel)
            return jax.lax.pmean(local, ("data", "expert"))

        loss, grads = jax.value_and_grad(global_loss)(params)
        # same completion rule as make_ep_train_step: the model axis is
        # conjugate-exact per cell, so only the token-sharding cells are
        # psum'd (expert leaves got their cross-cell sums via the
        # all_to_all transpose within their data row)
        inv = 1.0 / n_cells
        grads = {k: jax.lax.psum(g, ("data",) if k in EXPERT_KEYS
                                 else ("data", "expert")) * inv
                 for k, g in grads.items()}
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, m, v = opt.adamw_tree(params, grads, m, v, step, lr,
                                      weight_decay=wd, decay_mask=mask)
        return params, m, v, loss

    pspec = dict(specs)
    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(pspec, pspec, pspec, P(("data", "expert")),
                  P(("data", "expert")), P(), P(), P()),
        out_specs=(pspec, pspec, pspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


# --- Adafactor under EP x TP ------------------------------------------------
#
# The dp x ep Adafactor rationale (expert slabs are the parameter bulk)
# composes with the TP gathered-stats rule (ops/adafactor.step shard_axes/
# axis_name): expert slabs are sharded over BOTH axes — "expert" on their
# leading (invariance-by-construction) dim and "model" on a trailing dim
# (fcw dim -2, fcprojw/fcb dim -1), so the model-axis means complete with
# pmeans while the expert axis needs nothing.  The factored/full layout is
# judged on GLOBAL shapes (tensor_parallel.tp_global_shapes — param_shapes
# already carries the (L, E, ...) expert dims for a MoE config), so the
# state layout never depends on the mesh.

def ep_tp_global_shapes(cfg: ViTConfig, vocab_parallel: bool = False):
    from . import tensor_parallel as TPmod
    return TPmod.tp_global_shapes(cfg, vocab_parallel)


def ep_tp_af_state_specs(cfg: ViTConfig, vocab_parallel: bool = False,
                         min_factor: int = 0):
    from ..ops import adafactor as AF
    mf = min_factor or AF.MIN_FACTOR
    return AF.state_specs(ep_tp_global_shapes(cfg, vocab_parallel),
                          ep_tp_param_specs(cfg, vocab_parallel), mf)


def init_ep_tp_af_state(ep_tp_params, cfg: ViTConfig, mesh: Mesh,
                        vocab_parallel: bool = False, min_factor: int = 0):
    from ..ops import adafactor as AF
    import functools
    mf = min_factor or AF.MIN_FACTOR
    gshapes = ep_tp_global_shapes(cfg, vocab_parallel)
    shapes = jax.eval_shape(
        functools.partial(AF.init_state, min_factor=mf), gshapes)
    sp = ep_tp_af_state_specs(cfg, vocab_parallel, mf)

    def place(tree, spt):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=NamedSharding(mesh, spt[k]))()
                for k, v in tree.items()}

    return AF.AdafactorState(place(shapes.vr, sp.vr), place(shapes.vc, sp.vc),
                             place(shapes.vf, sp.vf), {})


def make_ep_tp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                    weight_decay_2d_only: bool = True,
                                    relative_step: bool = True,
                                    vocab_parallel: bool = False,
                                    min_factor: int = 0):
    """dp x ep x tp training step with Adafactor state sharded like the
    weights (expert slabs over ("expert", "model"), attention over "model").

    Signature: (ep_tp_params, af_state, inputs, targets, step, lr, wd)
            -> (ep_tp_params, af_state, loss)
    """
    from ..ops import adafactor as AF
    assert cfg.is_moe and cfg.mode == "gpt", "EP x TP serves MoE gpt configs"
    ep = mesh.shape["expert"]
    tp = mesh.shape["model"]
    assert cfg.num_experts % ep == 0, (cfg.num_experts, ep)
    assert cfg.num_heads % tp == 0, (cfg.num_heads, tp)
    assert (4 * cfg.channels) % tp == 0
    if cfg.is_gqa:
        assert cfg.kv_heads % tp == 0, (cfg.kv_heads, tp)
    if vocab_parallel:
        assert basic.pad_vocab(cfg.vocab_size) % tp == 0
    specs = ep_tp_param_specs(cfg, vocab_parallel)
    n_cells = mesh.shape["data"] * ep
    gshapes = ep_tp_global_shapes(cfg, vocab_parallel)
    mf = min_factor or AF.MIN_FACTOR
    shard_axes = AF.shard_axes_from_specs(gshapes, specs, "model")
    stspec = AF.state_specs(gshapes, specs, mf)

    def spmd_step(params, st, inputs, targets, step, lr, wd):
        def global_loss(pa):
            local = _ep_tp_loss(pa, inputs, targets, cfg, ep,
                                vocab_parallel)
            return jax.lax.pmean(local, ("data", "expert"))

        loss, grads = jax.value_and_grad(global_loss)(params)
        # same completion rule as make_ep_tp_train_step
        inv = 1.0 / n_cells
        grads = {k: jax.lax.psum(g, ("data",) if k in EXPERT_KEYS
                                 else ("data", "expert")) * inv
                 for k, g in grads.items()}
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        fac = {k: AF._factored(v, mf) for k, v in gshapes.items()}
        params, st = AF.step(params, grads, st, step, lr, weight_decay=wd,
                             decay_mask=mask, relative_step=relative_step,
                             shard_axes=shard_axes, axis_name="model",
                             factored=fac)
        return params, st, loss

    pspec = dict(specs)
    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(pspec, stspec, P(("data", "expert")),
                  P(("data", "expert")), P(), P(), P()),
        out_specs=(pspec, stspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))
