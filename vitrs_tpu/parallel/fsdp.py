"""Fully-sharded data parallelism (FSDP / ZeRO-3) — GSPMD-native.

The reference has no distributed story at all (SURVEY.md §2 rows 26-27);
this module is the GSPMD form of the FSDP family: parameters AND
optimizer state live sharded across the mesh at rest, and XLA's GSPMD
partitioner inserts the all-gathers (param use), reduce-scatters (gradient
combine) and the sharded optimizer update from sharding annotations alone —
no hand-written collectives, unlike the shard_map modules (data_parallel /
tensor_parallel), because here the whole point is the *storage* layout, and
`jit(in_shardings=..., out_shardings=...)` is the canonical way to pin one.

Memory at rest per device: (params + m + v) / mesh.size + activations —
the configuration that puts GPT-2 1.5B's 9.3 GB of state onto 8 chips at
1.2 GB each.  Compute math is IDENTICAL to plain DP (batch sharded on the
same axis): verified vs single device in tests/test_fsdp.py.

Sharding rule: each canonical tensor (params.py's 16-tensor order) shards
its LARGEST axis divisible by the mesh size (ties → later axis, which is
usually the contraction axis and gathers straight into the matmul); tensors
with no divisible axis stay replicated.  wte (50304, 768) and the stacked-L
weight blocks (L, 3C, C) etc. all shard on an 8-divisible axis at every
real config.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ViTConfig
from ..models import model as M
from ..ops import optimizer as opt

AXIS = "fsdp"
REPLICA = "replica"


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(AXIS,))


def make_hybrid_mesh(replica: int, shard: int, devices=None) -> Mesh:
    """The standard cluster deployment: FSDP *inside* a fast-link domain
    ("fsdp" axis — the cards of one host, where the per-use all-gathers
    are cheap) × plain DP *across* domains ("replica" axis, which only
    carries the once-per-step gradient all-reduce).  Params/state shard over "fsdp" only and replicate over
    "replica"; the batch shards over both axes (every device is a data
    worker).  The step factories below are axis-count-agnostic — GSPMD
    reads the same annotations and adds the replica-axis grad all-reduce
    on its own."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[:replica * shard]).reshape(replica, shard)
    return Mesh(devices, axis_names=(REPLICA, AXIS))


def _shard_ways(mesh: Mesh) -> int:
    return mesh.shape[AXIS]


def batch_spec(mesh: Mesh) -> P:
    """Batch sharded over every mesh axis (replica × fsdp jointly)."""
    return P(tuple(mesh.axis_names))


def spec_for(shape, n: int) -> P:
    """Largest axis divisible by n (ties → later axis); else replicate."""
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if d % n == 0 and d >= best_dim:
            best, best_dim = i, d
    if best is None:
        return P()
    return P(*(AXIS if i == best else None for i in range(len(shape))))


def param_specs(params, mesh: Mesh):
    n = _shard_ways(mesh)
    return {k: spec_for(v.shape, n) for k, v in params.items()}


def place_params(params, mesh: Mesh):
    """Move a (host or single-device) param tree to its sharded-at-rest
    layout."""
    specs = param_specs(params, mesh)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in params.items()}


def init_opt_state(params, mesh: Mesh, dtype=jnp.float32):
    """AdamW m/v with the SAME shardings as their parameters (ZeRO-3: the
    optimizer state never exists unsharded anywhere)."""
    specs = param_specs(params, mesh)
    zeros = {k: functools.partial(jnp.zeros, v.shape, dtype)
             for k, v in params.items()}
    return tuple(
        {k: jax.jit(z, out_shardings=NamedSharding(mesh, specs[k]))()
         for k, z in zeros.items()}
        for _ in range(2))


def make_fsdp_train_step(cfg: ViTConfig, mesh: Mesh, params,
                         weight_decay: float = 0.1):
    """Jitted FSDP step: (params, m, v, inputs, targets, step, lr)
    -> (params, m, v, loss).

    `params` is only inspected for shapes (to fix the shardings).  params/
    m/v arrive and leave in the sharded-at-rest layout (donated: the update
    is in-place per shard); inputs/targets are batch-sharded on the same
    axis.  Everything between — gather for use, reduce-scatter of grads,
    sharded elementwise AdamW — is GSPMD's from the in/out shardings.
    """
    specs = param_specs(params, mesh)
    psh = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    batch_sh = NamedSharding(mesh, batch_spec(mesh))
    repl = NamedSharding(mesh, P())

    def step_fn(params, m, v, inputs, targets, step, lr):
        loss, grads = jax.value_and_grad(M.loss_fn)(params, inputs, targets,
                                                    cfg)
        # pin gradient layout to the param layout: GSPMD lowers the grad
        # combine to reduce-scatter instead of all-reduce
        grads = {k: jax.lax.with_sharding_constraint(
                     g, NamedSharding(mesh, specs[k]))
                 for k, g in grads.items()}
        params, m, v = opt.adamw_tree(params, grads, m, v, step, lr,
                                      weight_decay=weight_decay)
        return params, m, v, loss

    return jax.jit(
        step_fn,
        in_shardings=(psh, psh, psh, batch_sh, batch_sh, repl, repl),
        out_shardings=(psh, psh, psh, repl),
        donate_argnums=(0, 1, 2),
    )


# --- Adafactor under FSDP ----------------------------------------------------
#
# Unlike the shard_map TP variant (tensor_parallel.make_tp_train_step_
# adafactor, which completes cross-shard means with explicit pmeans), FSDP
# is GSPMD: the step body is the PLAIN global-view ops/adafactor.step and
# the partitioner inserts whatever collectives the factored row/col means
# need — sharded-dim semantics are exact by construction.  Sharding the
# state at rest matters less here than for AdamW (factored stats are
# ~1/1000 of a param copy), but the full-v leaves (bias/LN stacks) and any
# beta1 momentum mirror their parameter's spec, so nothing unsharded scales
# with the model.

def af_state_sharding(params, mesh: Mesh, min_factor: int = 0):
    """NamedSharding tree for an AdafactorState: vr drops the last param
    dim, vc the second-to-last, vf mirrors the param (state_specs rule)."""
    from ..ops import adafactor as AF
    sp = AF.state_specs(params, param_specs(params, mesh),
                        min_factor or AF.MIN_FACTOR)
    return AF.AdafactorState(
        *({k: NamedSharding(mesh, s[k]) for k in s}
          for s in (sp.vr, sp.vc, sp.vf)), {})


def init_af_state(params, mesh: Mesh, min_factor: int = 0):
    """Adafactor state created directly in the sharded-at-rest layout."""
    from ..ops import adafactor as AF
    mf = min_factor or AF.MIN_FACTOR
    shapes = jax.eval_shape(lambda p: AF.init_state(p, min_factor=mf), params)
    sh = af_state_sharding(params, mesh, mf)

    def place(tree, sht):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=sht[k])()
                for k, v in tree.items()}

    return AF.AdafactorState(place(shapes.vr, sh.vr), place(shapes.vc, sh.vc),
                             place(shapes.vf, sh.vf), {})


def place_af_state(state, params, mesh: Mesh, min_factor: int = 0):
    """Move a (host) AdafactorState into the FSDP layout (resume path)."""
    from ..ops import adafactor as AF
    sh = af_state_sharding(params, mesh, min_factor)
    return AF.AdafactorState(
        *({k: jax.device_put(jnp.asarray(v), getattr(sh, f)[k])
           for k, v in getattr(state, f).items()}
          for f in ("vr", "vc", "vf")), {})


def make_fsdp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh, params,
                                   weight_decay_2d_only: bool = True,
                                   relative_step: bool = True,
                                   min_factor: int = 0):
    """Jitted FSDP step with Adafactor:
    (params, af_state, inputs, targets, step, lr, wd)
        -> (params, af_state, loss).
    `params` is only inspected for shapes/dtypes (fixes the shardings)."""
    from ..ops import adafactor as AF
    specs = param_specs(params, mesh)
    mf = min_factor or 0
    psh = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    stsh = af_state_sharding(params, mesh, mf)
    batch_sh = NamedSharding(mesh, batch_spec(mesh))
    repl = NamedSharding(mesh, P())

    def step_fn(params, st, inputs, targets, step, lr, wd):
        loss, grads = jax.value_and_grad(M.loss_fn)(params, inputs, targets,
                                                    cfg)
        grads = {k: jax.lax.with_sharding_constraint(
                     g, NamedSharding(mesh, specs[k]))
                 for k, g in grads.items()}
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, st = AF.step(params, grads, st, step, lr, weight_decay=wd,
                             decay_mask=mask, relative_step=relative_step,
                             min_factor=mf or AF.MIN_FACTOR)
        return params, st, loss

    return jax.jit(
        step_fn,
        in_shardings=(psh, stsh, batch_sh, batch_sh, repl, repl, repl),
        out_shardings=(psh, stsh, repl),
        donate_argnums=(0, 1),
    )
