"""Data-parallel tests on the 8-virtual-device CPU mesh (SURVEY.md §4: the
JAX-native fake backend for testing DP/reduce-scatter without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.parallel import data_parallel as dp

CFG = get_config("vit-tiny-4-cifar10", use_flash=False).replace(
    num_layers=2, channels=32, num_heads=2)


def _data(B=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, (B,)))


def test_mesh_has_8_devices():
    mesh = dp.make_mesh()
    assert mesh.size == 8


def test_dp_step_matches_single_device():
    """The sharded step must produce the same params as a single-device step
    on the full batch (same total gradient, same AdamW math)."""
    mesh = dp.make_mesh()
    params = PRM.init_params(CFG, jax.random.PRNGKey(0))
    images, labels = _data()

    # single-device reference
    loss_ref, grads = jax.value_and_grad(M.loss_fn)(params,
                                                    jnp.asarray(images),
                                                    jnp.asarray(labels), CFG)
    flat_p = PRM.flatten_params(params, CFG)
    flat_g = PRM.flatten_params(grads, CFG)
    n = flat_p.shape[0]
    want_p, want_m, want_v = opt.adamw_step(
        flat_p, flat_g, jnp.zeros(n), jnp.zeros(n),
        jnp.asarray(1, jnp.int32), jnp.asarray(1e-3), weight_decay=0.01)

    # sharded step
    step_fn = dp.make_dp_train_step(CFG, mesh)
    m0, v0 = dp.init_sharded_opt_state(CFG, mesh)
    params_r = dp.replicate(params, mesh)
    new_params, m1, v1, loss = step_fn(
        params_r, m0, v0, dp.shard_batch(jnp.asarray(images), mesh),
        dp.shard_batch(jnp.asarray(labels), mesh),
        jnp.asarray(1, jnp.int32), jnp.asarray(1e-3, jnp.float32),
        jnp.asarray(0.01, jnp.float32))

    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    got_p = PRM.flatten_params(new_params, CFG)
    # tolerance: per-shard-then-psum reduction order vs full-batch reduction
    np.testing.assert_allclose(np.asarray(got_p), np.asarray(want_p),
                               rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(np.asarray(m1)[:n], np.asarray(want_m),
                               rtol=2e-4, atol=1e-7)


def test_dp_opt_state_is_sharded():
    """ZeRO-1: each device holds exactly 1/8 of m and v."""
    mesh = dp.make_mesh()
    m, v = dp.init_sharded_opt_state(CFG, mesh)
    shard_shapes = {s.data.shape for s in m.addressable_shards}
    assert shard_shapes == {(m.shape[0] // 8,)}


def test_dp_training_decreases_loss():
    mesh = dp.make_mesh()
    params = dp.replicate(PRM.init_params(CFG, jax.random.PRNGKey(1)), mesh)
    m, v = dp.init_sharded_opt_state(CFG, mesh)
    step_fn = dp.make_dp_train_step(CFG, mesh)
    images, labels = _data(seed=1)
    images = dp.shard_batch(jnp.asarray(images), mesh)
    labels = dp.shard_batch(jnp.asarray(labels), mesh)
    losses = []
    for i in range(1, 7):
        params, m, v, loss = step_fn(params, m, v, images, labels,
                                     jnp.asarray(i, jnp.int32),
                                     jnp.asarray(3e-3, jnp.float32),
                                     jnp.asarray(0.0, jnp.float32))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_dp_uint8_device_normalize_matches_float_path():
    """normalize=(mean,std) + uint8 batch == host-normalized float batch
    (the two input paths must produce identical losses; uint8 quantization
    is upstream of both, so the comparison is exact up to f32 rounding)."""
    mesh = dp.make_mesh()
    params = PRM.init_params(CFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, (16,))
    mean = np.array([0.4, 0.45, 0.5], np.float32)
    std = np.array([0.25, 0.3, 0.2], np.float32)
    host = (u8.astype(np.float32) / 255.0 - mean) / std

    # fresh param copies per call: the step donates params/m/v, and
    # replicate() may alias the source buffers
    args = lambda imgs: (
        dp.replicate(jax.tree.map(jnp.array, params), mesh),
        *dp.init_sharded_opt_state(CFG, mesh),
        dp.shard_batch(jnp.asarray(imgs), mesh),
        dp.shard_batch(jnp.asarray(labels), mesh),
        jnp.asarray(1, jnp.int32), jnp.asarray(1e-3, jnp.float32),
        jnp.asarray(0.01, jnp.float32))

    step_n = dp.make_dp_train_step(CFG, mesh, normalize=(mean, std))
    _, _, _, loss_u8 = step_n(*args(u8))
    step_f = dp.make_dp_train_step(CFG, mesh)
    _, _, _, loss_f = step_f(*args(host))
    np.testing.assert_allclose(float(loss_u8), float(loss_f), rtol=1e-6)
    # float inputs pass through a normalize-enabled step untouched
    _, _, _, loss_pass = step_n(*args(host))
    np.testing.assert_allclose(float(loss_pass), float(loss_f), rtol=1e-6)


def test_dp_clip_norm_bounds_update():
    """clip_norm must scale the applied gradient so its global norm is at
    most the clip, and the logged metric stays the PRE-clip norm."""
    mesh = dp.make_mesh()
    params = PRM.init_params(CFG, jax.random.PRNGKey(4))
    images, labels = _data(seed=4)
    images = jnp.asarray(images) * 50.0        # inflate grads so clip binds
    args_tail = (dp.shard_batch(images, mesh),
                 dp.shard_batch(jnp.asarray(labels), mesh),
                 jnp.asarray(1, jnp.int32), jnp.asarray(0.0, jnp.float32),
                 jnp.asarray(0.0, jnp.float32))      # lr=0: isolate grads

    step_ref = dp.make_dp_train_step(CFG, mesh, return_grad_norm=True)
    _, _, _, _, gn_raw = step_ref(
        dp.replicate(jax.tree.map(jnp.array, params), mesh),
        *dp.init_sharded_opt_state(CFG, mesh), *args_tail)
    gn_raw = float(gn_raw)
    assert gn_raw > 1.0                        # clip at 1.0 will bind

    step_clip = dp.make_dp_train_step(CFG, mesh, return_grad_norm=True,
                                      clip_norm=1.0)
    _, m1, _, _, gn_logged = step_clip(
        dp.replicate(jax.tree.map(jnp.array, params), mesh),
        *dp.init_sharded_opt_state(CFG, mesh), *args_tail)
    # metric reports the pre-clip norm
    np.testing.assert_allclose(float(gn_logged), gn_raw, rtol=1e-5)
    # AdamW first moment after one step = (1-b1) * applied grad, so the
    # applied-grad global norm is ||m1|| / (1-b1) — must equal the clip
    applied = np.linalg.norm(np.concatenate(
        [np.asarray(s.data).ravel() for s in m1.addressable_shards])) / 0.1
    np.testing.assert_allclose(applied, 1.0, rtol=1e-4)
