"""Ring attention (context parallelism) vs single-device full attention, on
the 8-virtual-device CPU mesh — forward, BACKWARD (round-3 custom VJP), and
the dp×cp GPT training step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.parallel import data_parallel as dp
from vitrs_tpu.parallel import ring_attention as RA
from vitrs_tpu.parallel.ring_attention import make_ring_attention


def _qkv(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32))
                 for _ in range(3))


def _reference(q, k, v, causal):
    D = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(D)
    if causal:
        T = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full(causal):
    mesh = dp.make_mesh()
    B, H, T, D = 2, 2, 64, 16          # T sharded 8 ways -> 8 per device
    q, k, v = _qkv(B, H, T, D, seed=1)
    ring = make_ring_attention(mesh, causal=causal)
    got = ring(q, k, v)                 # shard_map handles placement
    want = _reference(q, k, v, causal)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_grads_match_full(causal):
    """The round-3 ring VJP (second ring pass: dq local, dk/dv riding the
    rotating block) must match autodiff through dense attention."""
    mesh = dp.make_mesh()
    B, H, T, D = 2, 2, 64, 16
    q, k, v = _qkv(B, H, T, D, seed=3)
    ring = make_ring_attention(mesh, causal=causal)

    def f_ring(q, k, v):
        return jnp.sum(jnp.sin(ring(q, k, v)))

    def f_ref(q, k, v):
        return jnp.sum(jnp.sin(_reference(q, k, v, causal)))

    np.testing.assert_allclose(float(f_ring(q, k, v)), float(f_ref(q, k, v)),
                               rtol=2e-5)
    g_ring = jax.grad(f_ring, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_ring, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=3e-5)


def test_dp_cp_train_step_matches_single_device():
    """One dp×cp step (batch 2-way, sequence 4-way) == one single-device
    step: same loss, same updated parameters (the grad-parity bar every
    other parallelism mode meets)."""
    cfg = get_config("gpt-nano", use_flash=False)       # T=16, cp=4 -> 4/dev
    rng = np.random.default_rng(0)
    B = 4
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))
    step = jnp.asarray(1, jnp.int32)
    lr = jnp.asarray(1e-3, jnp.float32)
    wd = jnp.asarray(0.01, jnp.float32)

    # reference: the (already-verified) dp step on a 1-device mesh
    mesh1 = dp.make_mesh(1)
    p_ref = dp.replicate(PRM.init_params(cfg, jax.random.PRNGKey(0)), mesh1)
    m1, v1 = dp.init_sharded_opt_state(cfg, mesh1)
    ref_step = dp.make_dp_train_step(cfg, mesh1)
    p_ref, _, _, loss_ref = ref_step(p_ref, m1, v1, x, y, step, lr, wd)

    mesh = RA.make_mesh_dp_cp(dp=2, cp=4)
    params = jax.device_put(PRM.init_params(cfg, jax.random.PRNGKey(0)),
                            jax.sharding.NamedSharding(
                                mesh, jax.sharding.PartitionSpec()))
    m2, v2 = RA.init_cp_opt_state(cfg, mesh)
    cp_step = RA.make_cp_train_step(cfg, mesh)
    params, m2, v2, loss_cp = cp_step(
        params, m2, v2, RA.shard_cp_batch(x, mesh),
        RA.shard_cp_batch(y, mesh), step, lr, wd)

    np.testing.assert_allclose(float(loss_cp), float(loss_ref), rtol=2e-5)
    for kk in sorted(params):
        np.testing.assert_allclose(
            np.asarray(params[kk]), np.asarray(p_ref[kk]),
            rtol=2e-4, atol=2e-6, err_msg=kk)


def test_ring_is_sharded_over_sequence():
    mesh = dp.make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P
    B, H, T, D = 1, 2, 64, 16
    q, k, v = _qkv(B, H, T, D, seed=2)
    sharding = NamedSharding(mesh, P(None, None, "data", None))
    q, k, v = (jax.device_put(x, sharding) for x in (q, k, v))
    ring = make_ring_attention(mesh, causal=False)
    out = ring(q, k, v)
    # output keeps the sequence sharding
    shard_ts = {s.data.shape[2] for s in out.addressable_shards}
    assert shard_ts == {T // 8}


def test_dp_cp_gqa_small_kv_ring_grads_match_single_device():
    """GQA through the ring: only the KH-head K/V blocks rotate (ring traffic
    / group size, fwd AND bwd) with per-step local expansion — the dp x cp
    GRADIENTS must match the single-device model.  (Gradients, not
    post-Adam params: at step 1 the update is ±lr·sign(g), which flips on
    near-zero grads — the same caveat as the TP parity tests.)"""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     num_kv_heads=2, pos_emb="rope")
    rng = np.random.default_rng(2)
    B = 4
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))

    from vitrs_tpu.models import model as M
    params = PRM.init_params(cfg, jax.random.PRNGKey(2))
    loss_ref, g_ref = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)

    mesh = RA.make_mesh_dp_cp(dp=2, cp=4)

    def spmd(p, xx, yy):
        loss, g = jax.value_and_grad(RA._gpt_cp_loss_local)(p, xx, yy, cfg, 4)
        g = jax.tree.map(
            lambda t: jax.lax.pmean(jax.lax.pmean(t, "ctx"), "data"), g)
        return (jax.lax.pmean(jax.lax.pmean(loss, "ctx"), "data"), g)

    fn = jax.jit(shard_map(spmd, mesh=mesh,
                           in_specs=(P(), P("data", "ctx"),
                                     P("data", "ctx")),
                           out_specs=(P(), P()), check_rep=False))
    loss_cp, g_cp = fn(
        jax.device_put(params, jax.sharding.NamedSharding(mesh, P())),
        RA.shard_cp_batch(x, mesh), RA.shard_cp_batch(y, mesh))

    np.testing.assert_allclose(float(loss_cp), float(loss_ref), rtol=2e-5)
    for kk in sorted(g_ref):
        g = np.asarray(g_ref[kk])
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(g_cp[kk]), g,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=kk)


def test_ring_gqa_small_kv_matches_expanded():
    """ring(q, small k/v) must equal ring(q, pre-expanded k/v) bitwise-ish
    (same einsums after the local repeat) — fwd and grads, with the GQA
    dk/dv group-summed back."""
    from vitrs_tpu.parallel.ring_attention import make_ring_attention
    from jax.sharding import Mesh
    H, KH, D, n = 4, 2, 8, 4
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    ring = make_ring_attention(mesh, causal=True)
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.standard_normal((1, H, 16 * n, D), dtype=np.float32))
    ks = jnp.asarray(rng.standard_normal((1, KH, 16 * n, D),
                                         dtype=np.float32))
    vs = jnp.asarray(rng.standard_normal((1, KH, 16 * n, D),
                                         dtype=np.float32))
    kf = jnp.repeat(ks, H // KH, axis=1)
    vf = jnp.repeat(vs, H // KH, axis=1)

    np.testing.assert_allclose(np.asarray(ring(q, ks, vs)),
                               np.asarray(ring(q, kf, vf)),
                               rtol=2e-5, atol=2e-6)

    def f_small(q, k, v):
        return jnp.sum(jnp.sin(ring(q, k, v)))

    gq_s, gk_s, gv_s = jax.grad(f_small, argnums=(0, 1, 2))(q, ks, vs)
    gq_f, gk_f, gv_f = jax.grad(f_small, argnums=(0, 1, 2))(q, kf, vf)
    np.testing.assert_allclose(np.asarray(gq_s), np.asarray(gq_f),
                               rtol=3e-4, atol=3e-5)
    # expanded grads group-sum to the small grads
    B, _, T, _ = np.asarray(gk_f).shape
    np.testing.assert_allclose(
        np.asarray(gk_s),
        np.asarray(gk_f).reshape(1, KH, H // KH, T, D).sum(axis=2),
        rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(gv_s),
        np.asarray(gv_f).reshape(1, KH, H // KH, T, D).sum(axis=2),
        rtol=3e-4, atol=3e-5)


def _reference_window(q, k, v, window):
    D = q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(D)
    T = q.shape[2]
    keep = jnp.tril(jnp.ones((T, T), bool))
    if window:
        # query t sees keys in (t-window, t] — basic.attention_dense band
        keep &= ~jnp.tril(jnp.ones((T, T), bool), k=-window)
    s = jnp.where(keep, s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


@pytest.mark.parametrize("window", [4, 8, 21, 64])
def test_banded_ring_matches_dense_window(window):
    """Sliding window through the banded ring (window <= shard width = one
    neighbor hop; larger windows span several shards; window >= T reduces
    to dense causal) vs the dense band reference."""
    mesh = dp.make_mesh()
    B, H, T, D = 2, 2, 64, 16                 # 8 shards x 8 rows
    q, k, v = _qkv(B, H, T, D, seed=7)
    ring = make_ring_attention(mesh, causal=True, window=window)
    got = ring(q, k, v)
    want = _reference_window(q, k, v, window)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [8, 21])
def test_banded_ring_grads_match_dense_window(window):
    """The banded backward: dk/dv ride the shortened ring and take ONE
    direct ppermute home — grads must match dense-band autodiff."""
    mesh = dp.make_mesh()
    B, H, T, D = 2, 2, 64, 16
    q, k, v = _qkv(B, H, T, D, seed=8)
    ring = make_ring_attention(mesh, causal=True, window=window)

    def f_ring(q, k, v):
        return jnp.sum(jnp.sin(ring(q, k, v)))

    def f_ref(q, k, v):
        return jnp.sum(jnp.sin(_reference_window(q, k, v, window)))

    np.testing.assert_allclose(float(f_ring(q, k, v)), float(f_ref(q, k, v)),
                               rtol=2e-5)
    g_ring = jax.grad(f_ring, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_ring, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=3e-5)


def test_dp_cp_window_train_grads_match_single_device():
    """A windowed GQA+rope GPT (window=5 spans two 4-row shards at cp=4,
    T=16) under dp x cp: gradients match the single-device windowed model —
    the roadmap's 'sliding window under CP' composition."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     num_kv_heads=2, pos_emb="rope", window=5)
    rng = np.random.default_rng(9)
    B = 4
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, cfg.max_seq_len)))

    from vitrs_tpu.models import model as M
    params = PRM.init_params(cfg, jax.random.PRNGKey(9))
    loss_ref, g_ref = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)

    mesh = RA.make_mesh_dp_cp(dp=2, cp=4)

    def spmd(p, xx, yy):
        loss, g = jax.value_and_grad(RA._gpt_cp_loss_local)(p, xx, yy, cfg, 4)
        g = jax.tree.map(
            lambda t: jax.lax.pmean(jax.lax.pmean(t, "ctx"), "data"), g)
        return (jax.lax.pmean(jax.lax.pmean(loss, "ctx"), "data"), g)

    fn = jax.jit(shard_map(spmd, mesh=mesh,
                           in_specs=(P(), P("data", "ctx"),
                                     P("data", "ctx")),
                           out_specs=(P(), P()), check_rep=False))
    loss_cp, g_cp = fn(
        jax.device_put(params, jax.sharding.NamedSharding(mesh, P())),
        RA.shard_cp_batch(x, mesh), RA.shard_cp_batch(y, mesh))

    np.testing.assert_allclose(float(loss_cp), float(loss_ref), rtol=2e-5)
    for kk in sorted(g_ref):
        g = np.asarray(g_ref[kk])
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(np.asarray(g_cp[kk]), g,
                                   rtol=5e-4, atol=2e-5 * scale, err_msg=kk)


def test_banded_ring_hop_count():
    """The banded ring must run ceil((W-1)/Tk)+1 hops, not n — the whole
    point (O(window) comm/compute)."""
    from vitrs_tpu.parallel.ring_attention import _ring_hops
    assert _ring_hops(8, 0, 8) == 8          # dense: full loop
    assert _ring_hops(8, 1, 8) == 1          # self only
    assert _ring_hops(8, 8, 8) == 2          # own + previous shard
    assert _ring_hops(8, 9, 8) == 2
    assert _ring_hops(8, 17, 8) == 3
    assert _ring_hops(8, 1000, 8) == 8       # clamps at n
