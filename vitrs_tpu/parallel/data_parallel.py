"""Data parallelism over a device mesh — shard_map + reduce-scatter + ZeRO-1.

The reference is entirely single-threaded (SURVEY.md §2 rows 26-27: no
threads/MPI/NCCL anywhere); its only parallelism is the batch dimension of its
scalar loops.  The scale-out story here (SURVEY.md §5.8, the north-star
requirement) is:

  * mesh: one "data" axis over all cards, batch sharded;
  * gradient combine: `lax.psum_scatter` (reduce-scatter) — each
    device receives only its 1/N slice of the summed flat gradient;
  * ZeRO-1: AdamW moments m/v live sharded (1/N per device); each device
    updates its parameter shard (ops/optimizer.adamw_step), then
    `all_gather`s the updated parameters — reduce-scatter + all-gather
    back-to-back is the bandwidth-optimal decomposition of the naive
    all-reduce, and the optimizer state never materializes unsharded;
  * multi-host: the same program under `jax.distributed.initialize` (the mesh
    spans all processes; nothing else changes).
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
from ..ops import optimizer as opt


def make_mesh(n_devices: int = 0, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first n_devices devices (0 = all)."""
    if devices is None:
        devices = jax.devices()
        if n_devices:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def opt_state_shard_size(cfg: ViTConfig, mesh: Mesh) -> int:
    n = PRM.num_parameters(cfg)
    return _ceil_to(n, mesh.size) // mesh.size


def init_sharded_opt_state(cfg: ViTConfig, mesh: Mesh):
    """ZeRO-1 m/v: flat f32, sharded over the data axis."""
    n_pad = opt_state_shard_size(cfg, mesh) * mesh.size
    sharding = NamedSharding(mesh, P("data"))
    zeros = functools.partial(jnp.zeros, (n_pad,), jnp.float32)
    m = jax.jit(zeros, out_shardings=sharding)()
    v = jax.jit(zeros, out_shardings=sharding)()
    return m, v


def make_dp_train_step(cfg: ViTConfig, mesh: Mesh, accum_steps: int = 1,
                       return_grad_norm: bool = False,
                       mixup_alpha: float = 0.0,
                       normalize=None, clip_norm: float = 0.0,
                       decay_2d_only: bool = False):
    """Build the jitted SPMD training step.

    Signature: (params, m, v, inputs, targets, step, lr, wd)
            -> (params, m, v, loss)
    with params replicated, m/v flat-sharded, inputs/targets batch-sharded.

    accum_steps > 1 enables gradient accumulation (SURVEY.md §7 stage 4): the
    per-device batch is split into accum_steps micro-batches scanned
    sequentially, their grads averaged before the reduce-scatter — same math,
    1/accum_steps the activation memory.

    mixup_alpha > 0 (vit mode) applies device-side mixup per step: images
    convex-combined with a shuffled copy of the local batch (lam ~
    Beta(alpha, alpha), one draw per device per step, keyed on (step,
    device)); loss = lam*CE(y) + (1-lam)*CE(y[perm]).  Runs on-device after
    the H2D transfer, so the host loader stays unchanged.
    """
    n = PRM.num_parameters(cfg)
    n_pad = _ceil_to(n, mesh.size)
    shard = n_pad // mesh.size
    use_mixup = mixup_alpha > 0.0 and cfg.mode == "vit"

    # normalize = (mean, std) enables device-side input normalization: the
    # loader ships uint8 (4x less H2D traffic), and (x/255 - mean)/std
    # folds into the first XLA fusion on device.  float inputs pass through untouched.
    if normalize is not None:
        _nmean = jnp.asarray(normalize[0], jnp.float32)
        _ninv = jnp.asarray(1.0 / normalize[1], jnp.float32)

    def _prep(inputs):
        if normalize is not None and inputs.dtype == jnp.uint8:
            return (inputs.astype(jnp.float32) * (1.0 / 255.0)
                    - _nmean) * _ninv
        return inputs

    def _mixup_loss(params, inputs, targets, step):
        key = jax.random.fold_in(jax.random.PRNGKey(0x31A5), step)
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        k_lam, k_perm = jax.random.split(key)
        lam = jax.random.beta(k_lam, mixup_alpha, mixup_alpha)
        lam = lam.astype(inputs.dtype)
        perm = jax.random.permutation(k_perm, inputs.shape[0])
        mixed = lam * inputs + (1.0 - lam) * inputs[perm]
        logits = M.vit_forward(params, mixed, cfg, train=True)
        from ..ops import basic
        if cfg.label_smoothing > 0.0:
            ce = lambda y: jnp.mean(basic.cross_entropy_smoothed(
                logits, y, cfg.label_smoothing))
        else:
            ce = lambda y: jnp.mean(basic.cross_entropy_from_logits(logits, y))
        lam32 = lam.astype(jnp.float32)
        return lam32 * ce(targets) + (1.0 - lam32) * ce(targets[perm])

    # stochastic-depth / head-dropout rng: per (step, device), so DP devices
    # drop independently and the psum'd gradient is the dropout-SGD estimate
    needs_rng = cfg.mode == "vit" and (cfg.drop_path > 0.0
                                       or cfg.drop_rate > 0.0)

    def _loss(params, inputs, targets, step, micro=None):
        if needs_rng:
            key = jax.random.fold_in(jax.random.PRNGKey(0xDA7A), step)
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))
            if micro is not None:
                # distinct drop-path/dropout masks per micro-batch — without
                # this every accumulated micro-batch reuses one mask pattern,
                # correlating the summed gradients (advisor r2 finding)
                key = jax.random.fold_in(key, micro)
            return M.loss_fn(params, inputs, targets, cfg, rng=key)
        return M.loss_fn(params, inputs, targets, cfg)

    def _loss_and_grads(params, inputs, targets, step):
        if use_mixup:
            assert accum_steps == 1, "mixup + accumulation not wired"
            return jax.value_and_grad(_mixup_loss)(params, inputs, targets,
                                                   step)
        if accum_steps == 1:
            return jax.value_and_grad(_loss)(params, inputs, targets, step)
        micro = inputs.shape[0] // accum_steps
        xs = (inputs[:micro * accum_steps].reshape(
                  (accum_steps, micro) + inputs.shape[1:]),
              targets[:micro * accum_steps].reshape(accum_steps, micro),
              jnp.arange(accum_steps))

        def acc(carry, xy):
            loss_sum, g_sum = carry
            x, y, mi = xy
            loss, g = jax.value_and_grad(_loss)(params, x, y, step, mi)
            return (loss_sum + loss,
                    jax.tree_util.tree_map(jnp.add, g_sum, g)), None

        zero = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (loss_sum, g_sum), _ = jax.lax.scan(acc, (jnp.zeros(()), zero), xs)
        inv = 1.0 / accum_steps
        return loss_sum * inv, jax.tree_util.tree_map(lambda g: g * inv, g_sum)

    def spmd_step(params, m_shard, v_shard, inputs, targets, step, lr, wd):
        loss, grads = _loss_and_grads(params, _prep(inputs), targets, step)
        flat_g = PRM.flatten_params(grads, cfg)
        if n_pad != n:
            flat_g = jnp.pad(flat_g, (0, n_pad - n))
        # reduce-scatter the summed gradient: each device gets its 1/N slice
        g_shard = jax.lax.psum_scatter(flat_g, "data", scatter_dimension=0,
                                       tiled=True) / mesh.size
        gnorm = None
        if clip_norm > 0.0 or return_grad_norm:
            # SURVEY.md §5.5 metric; the reduce-scattered shard already
            # holds the global-mean gradient, so norm² sums across shards
            gnorm = jnp.sqrt(jax.lax.psum(jnp.sum(jnp.square(g_shard)),
                                          "data"))
        if clip_norm > 0.0:
            # global-norm clip on the sharded gradient — the production GPT
            # recipe's clip-at-1.0; the reported metric stays the PRE-clip
            # norm (the quantity worth monitoring)
            g_shard = g_shard * jnp.minimum(1.0, clip_norm / (gnorm + 1e-6))
        flat_p = PRM.flatten_params(params, cfg)
        if n_pad != n:
            flat_p = jnp.pad(flat_p, (0, n_pad - n))
        idx = jax.lax.axis_index("data")
        p_shard = jax.lax.dynamic_slice(flat_p, (idx * shard,), (shard,))
        if decay_2d_only:
            # llm.c's decay policy (matrix tensors only) in the flat form:
            # run the fused kernel with wd=0 and apply the masked decoupled
            # term from the pre-update shard — exact, since the kernel's own
            # wd term is decoupled (reads the OLD p)
            p_old = p_shard
            mask_shard = jax.lax.dynamic_slice(
                _decay_mask_flat(cfg, n_pad), (idx * shard,), (shard,))
            p_shard, m_shard, v_shard = opt.adamw_step(
                p_shard, g_shard, m_shard, v_shard, step, lr,
                weight_decay=0.0)
            p_shard = (p_shard - lr * wd * mask_shard * p_old
                       ).astype(p_shard.dtype)
        else:
            p_shard, m_shard, v_shard = opt.adamw_step(
                p_shard, g_shard, m_shard, v_shard, step, lr,
                weight_decay=wd)
        flat_p_new = jax.lax.all_gather(p_shard, "data", tiled=True)
        new_params = PRM.unflatten_params(flat_p_new[:n], cfg)
        loss = jax.lax.pmean(loss, "data")
        if return_grad_norm:
            return new_params, m_shard, v_shard, loss, gnorm
        return new_params, m_shard, v_shard, loss

    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P("data"),
                  P(), P(), P()),
        out_specs=((P(), P("data"), P("data"), P(), P())
                   if return_grad_norm else
                   (P(), P("data"), P("data"), P())),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def make_dp_train_step_muon(cfg: ViTConfig, mesh: Mesh,
                            clip_norm: float = 0.0, momentum: float = 0.95,
                            weight_decay: float = 0.0):
    """DP training step with the hybrid Muon/AdamW optimizer (ops/muon.py).

    Signature: (params, state: MuonState, inputs, targets, step, lr, alr)
            -> (params, state, loss)
    params and state replicated, inputs/targets batch-sharded.  Gradients
    are pmean'd in TREE form (Muon's update needs matrix-shaped gradients —
    the flat ZeRO-1 layout of the AdamW path has nothing to orthogonalize),
    and the optimizer state stays replicated: at the scales Muon targets
    here the momentum tree is one param-copy, the price of keeping the
    Newton-Schulz chain a plain batched matmul."""
    from ..ops import muon as MU

    def spmd_step(params, state, inputs, targets, step, lr, alr):
        loss, grads = jax.value_and_grad(M.loss_fn, argnums=0)(
            params, inputs, targets, cfg)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        loss = jax.lax.pmean(loss, "data")
        if clip_norm > 0.0:
            gn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                              for g in jax.tree_util.tree_leaves(grads)))
            scale = jnp.minimum(1.0, clip_norm / (gn + 1e-6))
            grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
        params, state = MU.step(params, grads, state, step + 1, lr,
                                momentum=momentum, adamw_lr=alr,
                                weight_decay=weight_decay)
        return params, state, loss

    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))


def make_dp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True):
    """DP training step with Adafactor (ops/adafactor.py).

    Signature: (params, state: AdafactorState, inputs, targets, step, lr,
                wd) -> (params, state, loss)
    params and the (sublinear — O(rows+cols) per matrix) factored state stay
    replicated: at ~1/2000 of a param-copy there is nothing worth sharding.
    Gradients are pmean'd in tree form like the Muon step."""
    from ..ops import adafactor as AF

    def spmd_step(params, state, inputs, targets, step, lr, wd):
        loss, grads = jax.value_and_grad(M.loss_fn, argnums=0)(
            params, inputs, targets, cfg)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "data"), grads)
        loss = jax.lax.pmean(loss, "data")
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, state = AF.step(params, grads, state, step, lr,
                                weight_decay=wd, decay_mask=mask,
                                relative_step=relative_step)
        return params, state, loss

    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _decay_mask_flat(cfg: ViTConfig, n_pad: int):
    """Flat 0/1 mask over the canonical parameter vector: 1 where the
    tensor is matrix-shaped (decayed), 0 for 1-D vectors (biases, LN) —
    zero-padded to the ZeRO shard multiple (pad elements never decay)."""
    import numpy as _np
    shapes = PRM.param_shapes(cfg)
    mask = {k: _np.full(shp, 1.0 if len(shp) >= 2 else 0.0, _np.float32)
            for k, shp in shapes.items()}
    flat = PRM.flatten_params({k: jnp.asarray(v) for k, v in mask.items()},
                              cfg)
    if n_pad != flat.shape[0]:
        flat = jnp.pad(flat, (0, n_pad - flat.shape[0]))
    return flat


def shard_batch(batch, mesh: Mesh):
    """Place a host batch with leading dim sharded over the data axis."""
    sharding = NamedSharding(mesh, P("data"))
    return jax.device_put(batch, sharding)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)
