"""Rotary positional embeddings (config.pos_emb="rope", ops/rope.py).

Beyond-reference positional option (the reference's only scheme is the
learned wpe table, rusty_vit.rs:107).  Tests pin the defining property
(attention scores are a function of relative distance), the orthogonality
of the rotation (inverse round-trip — the hand-written VJPs rely on it),
and full-path parity: cache decode vs full forward, selective-remat flash
branch vs dense oracle, and composition with GQA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import generate as G
from vitrs_tpu.models import model as M
from vitrs_tpu.models import selective as S
from vitrs_tpu.ops.rope import apply_rope, rope_qk


def _cfg(**kw):
    return get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                      pos_emb="rope", **kw)


def test_rope_scores_depend_only_on_relative_distance():
    H, D, T = 2, 8, 12
    rng = np.random.default_rng(0)
    q1 = jnp.asarray(rng.standard_normal((1, 1, H * D), dtype=np.float32))
    k1 = jnp.asarray(rng.standard_normal((1, 1, H * D), dtype=np.float32))
    for delta in (0, 3, 7):
        scores = []
        for t in (0, 2, T - delta - 1):
            qr = apply_rope(q1, jnp.asarray([t + delta]), H)
            kr = apply_rope(k1, jnp.asarray([t]), H)
            scores.append(float(jnp.vdot(qr, kr)))
        np.testing.assert_allclose(scores[0], scores[1], rtol=1e-5)
        np.testing.assert_allclose(scores[0], scores[2], rtol=1e-5)


def test_rope_inverse_roundtrip():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 9, 32), dtype=np.float32))
    pos = jnp.arange(9) + 5
    y = apply_rope(apply_rope(x, pos, 4), pos, 4, inverse=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                               rtol=1e-5, atol=1e-6)
    # norm preservation (R orthogonal)
    np.testing.assert_allclose(float(jnp.linalg.norm(apply_rope(x, pos, 4))),
                               float(jnp.linalg.norm(x)), rtol=1e-6)


def test_rope_train_grads_and_wpe_unused():
    cfg = _cfg()
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    loss, g = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)
    assert np.isfinite(float(loss))
    # the wpe table is carried for checkpoint-layout parity but never read
    np.testing.assert_array_equal(np.asarray(g["wpe"]), 0.0)
    assert float(jnp.abs(g["qkvw"]).max()) > 0


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_rope_remat_grads_match_plain(kv_heads):
    cfg = _cfg(num_kv_heads=kv_heads)
    params = PRM.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    l0, g0 = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)
    l1, g1 = jax.value_and_grad(M.gpt_loss)(params, x, y,
                                            cfg.replace(remat=True))
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(np.asarray(g0[name]), np.asarray(g1[name]),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_rope_attn_branch_interpret_flash_vs_dense(kv_heads):
    """Selective-remat branch with rope: forward + grads vs the dense
    oracle — pins the in-branch rotation and its inverse-rotation VJP."""
    C, H = 32, 4
    D = C // H
    kvd = (kv_heads or H) * D
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 16, C), dtype=np.float32))
    args = (
        x,
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1 + 1),
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
        jnp.asarray(rng.standard_normal((C + 2 * kvd, C),
                                        dtype=np.float32) * 0.2),
        jnp.asarray(rng.standard_normal(C + 2 * kvd, dtype=np.float32) * 0.1),
        jnp.asarray(rng.standard_normal((C, C), dtype=np.float32) * 0.2),
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
    )

    def f_flash(*a):
        return jnp.sum(jnp.sin(S.attn_branch(*a, H, True, True, kv_heads,
                                             True)))

    def f_ref(*a):
        return jnp.sum(jnp.sin(S._attn_ref(*a, num_heads=H, causal=True,
                                           kv_heads=kv_heads, rope=True)))

    np.testing.assert_allclose(float(f_flash(*args)), float(f_ref(*args)),
                               rtol=2e-5)
    gf = jax.grad(f_flash, argnums=tuple(range(7)))(*args)
    gr = jax.grad(f_ref, argnums=tuple(range(7)))(*args)
    for a, b in zip(gf, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_rope_cache_decode_matches_full_forward(kv_heads):
    cfg = _cfg(num_kv_heads=kv_heads)
    params = PRM.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 6)))
    # prefill parity
    caches = G.init_kv_cache(cfg, 2, 8)
    lg, caches = G.forward_with_cache(params, prompt, caches, 0, cfg)
    full = M.gpt_forward(params, prompt, cfg)
    np.testing.assert_allclose(np.asarray(lg), np.asarray(full),
                               rtol=2e-4, atol=1e-4)
    # incremental decode parity at a later absolute position
    nxt = jnp.argmax(lg[:, -1], -1)
    lg1, _ = G.forward_with_cache(params, nxt[:, None], caches, 6, cfg)
    seq = jnp.concatenate([prompt, nxt[:, None]], axis=1)
    full1 = M.gpt_forward(params, seq, cfg)
    np.testing.assert_allclose(np.asarray(lg1[:, 0]),
                               np.asarray(full1[:, -1]),
                               rtol=3e-4, atol=2e-4)


def test_rope_generate_greedy_matches_full_recompute():
    cfg = _cfg()
    params = PRM.init_params(cfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 4)))
    out = G.generate(params, prompt, cfg, max_new=5,
                     key=jax.random.PRNGKey(0), temperature=0.0)
    seq = np.asarray(out)
    for t in range(4, 9):
        lg = M.gpt_forward(params, jnp.asarray(seq[:, :t]), cfg)
        np.testing.assert_array_equal(seq[:, t],
                                      np.asarray(jnp.argmax(lg[:, -1], -1)))


def test_rope_checkpoint_header_roundtrip(tmp_path):
    from vitrs_tpu import checkpoint as CKPT
    cfg = _cfg(num_kv_heads=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(6))
    path = str(tmp_path / "rope.bin")
    CKPT.save_checkpoint(path, params, cfg)
    _, file_cfg, _ = CKPT.load_checkpoint(path)
    assert file_cfg.pos_emb == "rope"
    assert file_cfg.num_kv_heads == 2


def test_rope_decode_step_multi_matches_full():
    cfg = _cfg()
    params = PRM.init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 4)))
    caches = G.init_kv_cache(cfg, 2, 8)
    lg0, caches = G.prefill_into_slot(params, prompt[0], caches, 0, cfg)
    nxt = jnp.argmax(lg0, -1)
    lg1, _ = G.decode_step_multi(params, jnp.asarray([nxt, 0]), caches,
                                 jnp.asarray([4, 0], jnp.int32), cfg)
    seq = jnp.concatenate([prompt, nxt[None, None]], axis=1)
    full = M.gpt_forward(params, seq, cfg)
    np.testing.assert_allclose(np.asarray(lg1[0]), np.asarray(full[0, -1]),
                               rtol=3e-4, atol=2e-4)


# --- rope under the parallel families (code-review r3 findings 1-3: the
# rope flag must reach every parallel forward, not just the DP model) -------

def _rope_cfg_l4():
    return get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                      pos_emb="rope", num_layers=4)


def _tokens(cfg, B=8, seed=9):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, 16)))
    return x, jnp.asarray(np.roll(np.asarray(x), -1, axis=1))


@pytest.mark.parametrize("sp", [False, True])
def test_rope_tp_loss_matches_single_device(sp):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vitrs_tpu.parallel import tensor_parallel as tp
    cfg = _rope_cfg_l4()
    mesh = tp.make_mesh_2d(dp=4, tp=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(9))
    x, y = _tokens(cfg)
    want = float(M.gpt_loss(params, x, y, cfg))
    tpp = tp.place_tp_params(params, cfg, mesh)
    step = tp.make_tp_train_step(cfg, mesh, sequence_parallel=sp)
    m, v = tp.init_tp_opt_state(tpp, mesh, cfg)
    dsh = NamedSharding(mesh, P("data"))
    _, _, _, loss = step(tpp, m, v, jax.device_put(x, dsh),
                         jax.device_put(y, dsh),
                         jnp.asarray(1, jnp.int32),
                         jnp.asarray(0.0, jnp.float32),
                         jnp.asarray(0.0, jnp.float32))
    np.testing.assert_allclose(float(loss), want, rtol=2e-5)


def test_rope_pp_loss_matches_single_device():
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vitrs_tpu.parallel import pipeline as pp
    cfg = _rope_cfg_l4()
    mesh = pp.make_mesh_dp_pp(dp=4, pp=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(10))
    x, y = _tokens(cfg, seed=10)
    want = float(M.gpt_loss(params, x, y, cfg))
    ppp = pp.place_pp_params(jax.device_get(params), cfg, mesh)
    m, v = pp.init_pp_opt_state(ppp, mesh, cfg)
    step = pp.make_pp_train_step(cfg, mesh, microbatches=2)
    dsh = NamedSharding(mesh, P("data"))
    _, _, _, loss = step(ppp, m, v, jax.device_put(x, dsh),
                         jax.device_put(y, dsh),
                         jnp.asarray(1, jnp.int32),
                         jnp.asarray(0.0, jnp.float32),
                         jnp.asarray(0.0, jnp.float32))
    np.testing.assert_allclose(float(loss), want, rtol=2e-5)


def test_rope_cp_loss_matches_single_device():
    from vitrs_tpu.parallel import ring_attention as RA
    cfg = _rope_cfg_l4().replace(num_layers=2)
    mesh = RA.make_mesh_dp_cp(dp=2, cp=4)
    params = PRM.init_params(cfg, jax.random.PRNGKey(11))
    x, y = _tokens(cfg, B=4, seed=11)
    want = float(M.gpt_loss(params, x, y, cfg))
    pc = jax.device_put(params, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    mc, vc = RA.init_cp_opt_state(cfg, mesh)
    step = RA.make_cp_train_step(cfg, mesh)
    _, _, _, loss = step(pc, mc, vc, RA.shard_cp_batch(np.asarray(x), mesh),
                         RA.shard_cp_batch(np.asarray(y), mesh),
                         jnp.asarray(1, jnp.int32),
                         jnp.asarray(0.0, jnp.float32),
                         jnp.asarray(0.0, jnp.float32))
    np.testing.assert_allclose(float(loss), want, rtol=2e-5)

