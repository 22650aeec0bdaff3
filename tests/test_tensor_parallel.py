"""Tensor parallelism: 2-D (data, model) mesh vs single-device reference, on
the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.parallel import tensor_parallel as tp

CFG = get_config("vit-tiny-4-cifar10", use_flash=False).replace(
    num_layers=2, channels=32, num_heads=2)   # 2 heads -> tp=2 head-aligned


def _data(B=8, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((B, 32, 32, 3), dtype=np.float32)),
            jnp.asarray(rng.integers(0, 10, (B,))))


def test_tp_param_round_trip():
    params = PRM.init_params(CFG, jax.random.PRNGKey(0))
    back = tp.from_tp_params(tp.to_tp_params(params, CFG), CFG)
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]),
                                      np.asarray(back[k]))


def test_tp_loss_matches_single_device():
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(CFG, jax.random.PRNGKey(0))
    images, labels = _data()
    want = float(M.loss_fn(params, images, labels, CFG))

    tpp = tp.place_tp_params(params, CFG, mesh)
    loss_fn = jax.jit(tp.make_tp_train_step(CFG, mesh))
    m, v = tp.init_tp_opt_state(tpp, mesh, CFG)
    data_sh = NamedSharding(mesh, P("data"))
    _, _, _, loss = loss_fn(tpp, m, v,
                            jax.device_put(images, data_sh),
                            jax.device_put(labels, data_sh),
                            jnp.asarray(1, jnp.int32),
                            jnp.asarray(0.0, jnp.float32),
                            jnp.asarray(0.0, jnp.float32))
    np.testing.assert_allclose(float(loss), want, rtol=2e-5)


def test_tp_gradients_match_single_device():
    """The TP gradients (recovered to canonical layout) must equal the
    single-device gradients.  (Comparing post-Adam params is too noisy: at
    step 1 the update is ±lr·sign(g), which flips on near-zero grads.)"""
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(CFG, jax.random.PRNGKey(1))
    images, labels = _data(seed=2)
    loss_ref, grads_ref = jax.value_and_grad(M.loss_fn)(params, images,
                                                        labels, CFG)

    specs = tp.tp_param_specs(CFG)

    def spmd_grads(p, inputs, targets):
        loss, g = jax.value_and_grad(tp.tp_loss)(p, inputs, targets, CFG)
        g = jax.tree_util.tree_map(lambda t: jax.lax.pmean(t, "data"), g)
        return jax.lax.pmean(loss, "data"), g

    from jax.experimental.shard_map import shard_map
    fn = jax.jit(shard_map(
        spmd_grads, mesh=mesh,
        in_specs=(dict(specs), P("data"), P("data")),
        out_specs=(P(), dict(specs)), check_rep=False))
    tpp = tp.place_tp_params(params, CFG, mesh)
    data_sh = NamedSharding(mesh, P("data"))
    loss, tp_grads = fn(tpp, jax.device_put(images, data_sh),
                        jax.device_put(labels, data_sh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=2e-5)
    got = tp.from_tp_params(jax.device_get(tp_grads), CFG)
    for k in grads_ref:
        g_ref = np.asarray(grads_ref[k])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]), g_ref,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=k)


def test_tp_weights_are_sharded():
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(CFG, jax.random.PRNGKey(0))
    tpp = tp.place_tp_params(params, CFG, mesh)
    C = CFG.channels
    # each model shard holds half the fc output dim
    shard_shapes = {s.data.shape for s in tpp["fcw"].addressable_shards}
    assert shard_shapes == {(CFG.num_layers, 4 * C // 2, C)}
    # replicated leaves hold the full tensor
    shard_shapes = {s.data.shape for s in tpp["ln1w"].addressable_shards}
    assert shard_shapes == {(CFG.num_layers, C)}


def test_tp_training_decreases_loss():
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(CFG, jax.random.PRNGKey(3))
    images, labels = _data(seed=3)
    tpp = tp.place_tp_params(params, CFG, mesh)
    m, v = tp.init_tp_opt_state(tpp, mesh, CFG)
    step = tp.make_tp_train_step(CFG, mesh)
    data_sh = NamedSharding(mesh, P("data"))
    images = jax.device_put(images, data_sh)
    labels = jax.device_put(labels, data_sh)
    losses = []
    for i in range(1, 7):
        tpp, m, v, loss = step(tpp, m, v, images, labels,
                               jnp.asarray(i, jnp.int32),
                               jnp.asarray(3e-3, jnp.float32),
                               jnp.asarray(0.0, jnp.float32))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_sp_loss_and_grads_match_single_device():
    """Sequence-parallel TP (Megatron-SP) vs single-device — loss and every
    gradient leaf.  mean-pool config so seq_len (64) divides tp."""
    cfg = CFG.replace(pool="mean", max_seq_len=64)
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(5))
    images, labels = _data(seed=5)
    loss_ref, grads_ref = jax.value_and_grad(M.loss_fn)(params, images,
                                                        labels, cfg)
    specs = tp.tp_param_specs(cfg)

    def spmd(p, x, y):
        loss, g = jax.value_and_grad(tp.tp_loss)(p, x, y, cfg, "model",
                                                 True, 2)
        for k in tp.SP_PARTIAL_GRADS:
            g[k] = jax.lax.psum(g[k], "model")
        g = jax.tree_util.tree_map(lambda t: jax.lax.pmean(t, "data"), g)
        return jax.lax.pmean(loss, "data"), g

    from jax.experimental.shard_map import shard_map
    fn = jax.jit(shard_map(spmd, mesh=mesh,
                           in_specs=(dict(specs), P("data"), P("data")),
                           out_specs=(P(), dict(specs)), check_rep=False))
    tpp = tp.place_tp_params(params, cfg, mesh)
    data_sh = NamedSharding(mesh, P("data"))
    loss, tp_grads = fn(tpp, jax.device_put(images, data_sh),
                        jax.device_put(labels, data_sh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=2e-5)
    got = tp.from_tp_params(jax.device_get(tp_grads), cfg)
    for k in grads_ref:
        g_ref = np.asarray(grads_ref[k])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]), g_ref, rtol=5e-4,
                                   atol=2e-5 * scale, err_msg=k)


def test_sp_training_decreases_loss():
    cfg = CFG.replace(pool="mean", max_seq_len=64)
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(6))
    images, labels = _data(seed=6)
    tpp = tp.place_tp_params(params, cfg, mesh)
    m, v = tp.init_tp_opt_state(tpp, mesh, cfg)
    step = tp.make_tp_train_step(cfg, mesh, sequence_parallel=True)
    dsh = NamedSharding(mesh, P("data"))
    images = jax.device_put(images, dsh)
    labels = jax.device_put(labels, dsh)
    losses = []
    for i in range(1, 6):
        tpp, m, v, loss = step(tpp, m, v, images, labels,
                               jnp.asarray(i, jnp.int32),
                               jnp.asarray(3e-3, jnp.float32),
                               jnp.asarray(0.0, jnp.float32))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


# --- GQA + sliding-window under TP (round-3 variants) ------------------------

GQA_CFG = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     num_kv_heads=2)   # kv_heads=2 -> tp=2 owns whole groups


def _gqa_data(B=8, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, GQA_CFG.vocab_size, (B, 16)))
    return x, jnp.asarray(np.roll(np.asarray(x), -1, axis=1))


def test_tp_gqa_param_round_trip():
    params = PRM.init_params(GQA_CFG, jax.random.PRNGKey(3))
    tpp = tp.to_tp_params(params, GQA_CFG)
    assert "qw" in tpp and "qkv3w" not in tpp
    back = tp.from_tp_params(tpp, GQA_CFG)
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]),
                                      np.asarray(back[k]))


@pytest.mark.parametrize("window", [0, 5])
def test_tp_gqa_loss_and_grads_match_single_device(window):
    cfg = GQA_CFG.replace(window=window)
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(4))
    x, y = _gqa_data(seed=4)
    loss_ref, grads_ref = jax.value_and_grad(M.loss_fn)(params, x, y, cfg)

    specs = tp.tp_param_specs(cfg)

    def spmd_grads(p, inputs, targets):
        loss, g = jax.value_and_grad(tp.tp_loss)(p, inputs, targets, cfg)
        g = jax.tree_util.tree_map(lambda t: jax.lax.pmean(t, "data"), g)
        return jax.lax.pmean(loss, "data"), g

    from jax.experimental.shard_map import shard_map
    fn = jax.jit(shard_map(
        spmd_grads, mesh=mesh,
        in_specs=(dict(specs), P("data"), P("data")),
        out_specs=(P(), dict(specs)), check_rep=False))
    tpp = tp.place_tp_params(params, cfg, mesh)
    data_sh = NamedSharding(mesh, P("data"))
    loss, tp_grads = fn(tpp, jax.device_put(x, data_sh),
                        jax.device_put(y, data_sh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=2e-5)
    got = tp.from_tp_params(jax.device_get(tp_grads), cfg)
    for k in grads_ref:
        g_ref = np.asarray(grads_ref[k])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]), g_ref,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=k)


def test_tp_gqa_kv_weights_sharded_small():
    """The GQA K/V leaves shard on their own (smaller) head dim: each model
    shard holds kv_dim/tp output rows — the parameter-memory win survives
    sharding."""
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(GQA_CFG, jax.random.PRNGKey(5))
    tpp = tp.place_tp_params(params, GQA_CFG, mesh)
    L, C, kvd = GQA_CFG.num_layers, GQA_CFG.channels, GQA_CFG.kv_dim
    assert ({s.data.shape for s in tpp["qw"].addressable_shards}
            == {(L, C // 2, C)})
    assert ({s.data.shape for s in tpp["kw"].addressable_shards}
            == {(L, kvd // 2, C)})


def test_tp_gqa_training_decreases_loss():
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(GQA_CFG, jax.random.PRNGKey(6))
    x, y = _gqa_data(seed=6)
    tpp = tp.place_tp_params(params, GQA_CFG, mesh)
    step_fn = tp.make_tp_train_step(GQA_CFG, mesh)
    m, v = tp.init_tp_opt_state(tpp, mesh, GQA_CFG)
    data_sh = NamedSharding(mesh, P("data"))
    xd, yd = jax.device_put(x, data_sh), jax.device_put(y, data_sh)
    losses = []
    for s in range(8):
        tpp, m, v, loss = step_fn(tpp, m, v, xd, yd,
                                  jnp.asarray(s + 1, jnp.int32),
                                  jnp.asarray(3e-3, jnp.float32),
                                  jnp.asarray(0.0, jnp.float32))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


# --- vocab parallelism (Megatron VocabParallelEmbedding + parallel CE) -------

VP_CFG = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32)
# vocab 97 pads to 128; tp=2 -> shard 1 is part-real/part-pad, tp=4 -> shard 3
# holds ONE real row (96) and 31 pad rows — both edge shapes exercised below.


def _vp_data(B=8, seed=0, cfg=None):
    cfg = cfg or VP_CFG
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, 16)))
    return x, jnp.asarray(np.roll(np.asarray(x), -1, axis=1))


def test_vp_param_round_trip():
    from vitrs_tpu.ops import basic
    params = PRM.init_params(VP_CFG, jax.random.PRNGKey(7))
    tpp = tp.to_tp_params(params, VP_CFG, vocab_parallel=True)
    assert tpp["wte"].shape[0] == basic.pad_vocab(VP_CFG.vocab_size)
    back = tp.from_tp_params(tpp, VP_CFG, vocab_parallel=True)
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]),
                                      np.asarray(back[k]))


@pytest.mark.parametrize("tp_size,pos_emb", [(2, "learned"), (4, "learned"),
                                             (2, "rope")])
def test_vp_loss_and_grads_match_single_device(tp_size, pos_emb):
    """Vocab-parallel embedding + head + CE vs the replicated single-device
    model: loss and ALL gradients (wte recovered from its vocab-row shards)
    must match; pad-row wte gradients must be exactly zero."""
    cfg = VP_CFG.replace(pos_emb=pos_emb)
    mesh = tp.make_mesh_2d(dp=8 // tp_size, tp=tp_size)
    params = PRM.init_params(cfg, jax.random.PRNGKey(8))
    x, y = _vp_data(seed=8, cfg=cfg)
    loss_ref, grads_ref = jax.value_and_grad(M.loss_fn)(params, x, y, cfg)

    specs = tp.tp_param_specs(cfg, vocab_parallel=True)

    def spmd_grads(p, inputs, targets):
        loss, g = jax.value_and_grad(tp.tp_loss)(
            p, inputs, targets, cfg, "model", False, tp_size,
            vocab_parallel=True)
        g = jax.tree_util.tree_map(lambda t: jax.lax.pmean(t, "data"), g)
        return jax.lax.pmean(loss, "data"), g

    from jax.experimental.shard_map import shard_map
    fn = jax.jit(shard_map(
        spmd_grads, mesh=mesh,
        in_specs=(dict(specs), P("data"), P("data")),
        out_specs=(P(), dict(specs)), check_rep=False))
    tpp = tp.place_tp_params(params, cfg, mesh, vocab_parallel=True)
    data_sh = NamedSharding(mesh, P("data"))
    loss, tp_grads = fn(tpp, jax.device_put(x, data_sh),
                        jax.device_put(y, data_sh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=2e-5)
    tp_grads = jax.device_get(tp_grads)
    np.testing.assert_array_equal(
        np.asarray(tp_grads["wte"][cfg.vocab_size:]), 0.0)
    got = tp.from_tp_params(tp_grads, cfg, vocab_parallel=True)
    for k in grads_ref:
        g_ref = np.asarray(grads_ref[k])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]), g_ref,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=k)


def test_vp_sp_loss_and_grads_match_single_device():
    """Vocab parallelism composed with sequence parallelism."""
    cfg = VP_CFG
    tp_size = 2
    mesh = tp.make_mesh_2d(dp=4, tp=tp_size)
    params = PRM.init_params(cfg, jax.random.PRNGKey(9))
    x, y = _vp_data(seed=9)
    loss_ref, grads_ref = jax.value_and_grad(M.loss_fn)(params, x, y, cfg)

    specs = tp.tp_param_specs(cfg, vocab_parallel=True)

    def spmd_grads(p, inputs, targets):
        loss, g = jax.value_and_grad(tp.tp_loss)(
            p, inputs, targets, cfg, "model", True, tp_size,
            vocab_parallel=True)
        for k in tp.SP_PARTIAL_GRADS:
            g[k] = jax.lax.psum(g[k], "model")
        g = jax.tree_util.tree_map(lambda t: jax.lax.pmean(t, "data"), g)
        return jax.lax.pmean(loss, "data"), g

    from jax.experimental.shard_map import shard_map
    fn = jax.jit(shard_map(
        spmd_grads, mesh=mesh,
        in_specs=(dict(specs), P("data"), P("data")),
        out_specs=(P(), dict(specs)), check_rep=False))
    tpp = tp.place_tp_params(params, cfg, mesh, vocab_parallel=True)
    data_sh = NamedSharding(mesh, P("data"))
    loss, tp_grads = fn(tpp, jax.device_put(x, data_sh),
                        jax.device_put(y, data_sh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=2e-5)
    got = tp.from_tp_params(jax.device_get(tp_grads), cfg,
                            vocab_parallel=True)
    for k in grads_ref:
        g_ref = np.asarray(grads_ref[k])
        scale = max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(got[k]), g_ref,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=k)


def test_vp_wte_sharded_and_training_decreases_loss():
    from vitrs_tpu.ops import basic
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(VP_CFG, jax.random.PRNGKey(10))
    x, y = _vp_data(seed=10)
    tpp = tp.place_tp_params(params, VP_CFG, mesh, vocab_parallel=True)
    Vp = basic.pad_vocab(VP_CFG.vocab_size)
    assert ({s.data.shape for s in tpp["wte"].addressable_shards}
            == {(Vp // 2, VP_CFG.channels)})
    step_fn = tp.make_tp_train_step(VP_CFG, mesh, vocab_parallel=True)
    m, v = tp.init_tp_opt_state(tpp, mesh, VP_CFG, vocab_parallel=True)
    data_sh = NamedSharding(mesh, P("data"))
    xd, yd = jax.device_put(x, data_sh), jax.device_put(y, data_sh)
    losses = []
    for s in range(8):
        tpp, m, v, loss = step_fn(tpp, m, v, xd, yd,
                                  jnp.asarray(s + 1, jnp.int32),
                                  jnp.asarray(3e-3, jnp.float32),
                                  jnp.asarray(0.0, jnp.float32))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
