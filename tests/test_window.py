"""Sliding-window attention (config.window).

Beyond-reference (the reference is full-causal only, rusty_vit.rs:529-537).
Ground truth is the dense windowed mask (tril minus the sub-band triangle),
itself pinned against a brute-force python loop.  The fused attention op
(local_window_size=(W-1, 0)) is held to it on values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import generate as G
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import basic
from vitrs_tpu.ops.attention import attention
from vitrs_tpu.utils import flops

NH, C = 2, 128          # head_dim 64, the models' own


def _qkv(B, T, C, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((B, T, 3 * C), dtype=np.float32))


def test_dense_window_matches_bruteforce():
    T, W = 9, 3
    qkv = _qkv(1, T, 8, seed=1)
    out, att = basic.attention_dense(qkv, 2, causal=True, window=W)
    att = np.asarray(att)
    for t in range(T):
        for s in range(T):
            visible = (s <= t) and (s > t - W)
            if not visible:
                assert att[0, :, t, s].max() == 0.0, (t, s)
    # row sums over the visible band are 1
    np.testing.assert_allclose(att.sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("T,W", [(256, 96), (300, 128), (128, 40)])
def test_flash_window_forward_matches_dense(T, W):
    qkv = _qkv(1, T, C, seed=T + W)
    got = attention(qkv, NH, causal=True, window=W)
    want, _ = basic.attention_dense(qkv, NH, causal=True, window=W)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("combined", [True, False])
@pytest.mark.parametrize("T,W", [(256, 96), (300, 150)])
def test_flash_window_grads_match_dense(T, W, combined):
    """combined=False runs the GQA form (K/V at one head) against the
    dense reference over expanded K/V."""
    kv_heads = NH if combined else 1
    D = C // NH
    qkv = _qkv(1, T, C, seed=7)[..., :C + 2 * kv_heads * D]

    def lf(x):
        return jnp.sum(jnp.sin(attention(x, NH, causal=True, window=W,
                                         kv_heads=kv_heads)))

    def ld(x):
        from vitrs_tpu.ops.attention import expand_packed
        return jnp.sum(jnp.sin(basic.attention_dense(
            expand_packed(x, NH, kv_heads), NH, causal=True, window=W)[0]))

    np.testing.assert_allclose(float(lf(qkv)), float(ld(qkv)), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(jax.grad(lf)(qkv)),
                               np.asarray(jax.grad(ld)(qkv)),
                               rtol=3e-4, atol=3e-5)


def test_window_projection_and_attention_grads():
    """Projection + windowed attention through autodiff: all three grads
    match the dense composition."""
    rng = np.random.default_rng(3)
    T, W = 256, 100
    ln1 = jnp.asarray(rng.standard_normal((1, T, C), dtype=np.float32))
    qkvw = jnp.asarray(rng.standard_normal((3 * C, C), dtype=np.float32) * 0.2)
    qkvb = jnp.asarray(rng.standard_normal(3 * C, dtype=np.float32) * 0.1)

    def lf(x, w, b):
        return jnp.sum(jnp.sin(attention(basic.linear(x, w, b), NH,
                                         causal=True, window=W)))

    def ld(x, w, b):
        qkv = basic.linear(x, w, b)
        return jnp.sum(jnp.sin(basic.attention_dense(
            qkv, NH, causal=True, window=W)[0]))

    np.testing.assert_allclose(float(lf(ln1, qkvw, qkvb)),
                               float(ld(ln1, qkvw, qkvb)), rtol=2e-5)
    gf = jax.grad(lf, argnums=(0, 1, 2))(ln1, qkvw, qkvb)
    gd = jax.grad(ld, argnums=(0, 1, 2))(ln1, qkvw, qkvb)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=1e-4)


def test_selective_attn_branch_window_interpret():
    from vitrs_tpu.models import selective as S
    rng = np.random.default_rng(4)
    T, W = 256, 80
    x = jnp.asarray(rng.standard_normal((1, T, C), dtype=np.float32))
    args = (
        x,
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1 + 1),
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
        jnp.asarray(rng.standard_normal((3 * C, C), dtype=np.float32) * 0.2),
        jnp.asarray(rng.standard_normal(3 * C, dtype=np.float32) * 0.1),
        jnp.asarray(rng.standard_normal((C, C), dtype=np.float32) * 0.2),
        jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
    )

    def lf(*a):
        return jnp.sum(jnp.sin(S.attn_branch(*a, NH, True, True, 0,
                                             False, W)))

    def lr(*a):
        return jnp.sum(jnp.sin(S._attn_ref(*a, num_heads=NH, causal=True,
                                           window=W)))

    np.testing.assert_allclose(float(lf(*args)), float(lr(*args)), rtol=2e-5)
    gf = jax.grad(lf, argnums=tuple(range(7)))(*args)
    gr = jax.grad(lr, argnums=tuple(range(7)))(*args)
    for a, b in zip(gf, gr):
        # fp32 reduction-order noise across T=256 accumulated weight grads;
        # a real masking defect would be O(1), not O(1e-4)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=2e-4)


def test_window_geq_T_is_full_attention():
    cfg = get_config("gpt-nano", use_flash=False)
    cfg_w = cfg.replace(window=64)          # window >= T=16: no-op
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    np.testing.assert_allclose(float(M.gpt_loss(params, x, y, cfg)),
                               float(M.gpt_loss(params, x, y, cfg_w)),
                               rtol=1e-6)


def test_window_model_train_and_remat_parity():
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     window=5)
    params = PRM.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    l0, g0 = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)
    # windowed loss differs from full attention (the mask bites)
    lf = M.gpt_loss(params, x, y, cfg.replace(window=0))
    assert abs(float(l0) - float(lf)) > 1e-6
    l1, g1 = jax.value_and_grad(M.gpt_loss)(params, x, y,
                                            cfg.replace(remat=True))
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(np.asarray(g0[name]), np.asarray(g1[name]),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kv_heads,pos_emb", [(0, "learned"), (2, "rope")])
def test_window_decode_matches_full_forward(kv_heads, pos_emb):
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     window=4, num_kv_heads=kv_heads, pos_emb=pos_emb)
    params = PRM.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 8)))
    caches = G.init_kv_cache(cfg, 2, 12)
    lg, caches = G.forward_with_cache(params, prompt, caches, 0, cfg)
    full = M.gpt_forward(params, prompt, cfg)
    np.testing.assert_allclose(np.asarray(lg), np.asarray(full),
                               rtol=3e-4, atol=2e-4)
    # decode one past the window boundary
    nxt = jnp.argmax(lg[:, -1], -1)
    lg1, _ = G.forward_with_cache(params, nxt[:, None], caches, 8, cfg)
    seq = jnp.concatenate([prompt, nxt[:, None]], axis=1)
    full1 = M.gpt_forward(params, seq, cfg)
    np.testing.assert_allclose(np.asarray(lg1[:, 0]), np.asarray(full1[:, -1]),
                               rtol=3e-4, atol=2e-4)


def test_window_checkpoint_header_roundtrip(tmp_path):
    from vitrs_tpu import checkpoint as CKPT
    cfg = get_config("gpt-nano", num_heads=4, channels=32, window=6,
                     pos_emb="rope", num_kv_heads=2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(3))
    path = str(tmp_path / "win.bin")
    CKPT.save_checkpoint(path, params, cfg)
    _, file_cfg, _ = CKPT.load_checkpoint(path)
    assert file_cfg.window == 6
    assert file_cfg.pos_emb == "rope"
    assert file_cfg.num_kv_heads == 2


def test_streaming_ring_matches_dense_cache_generation():
    """generate_streaming (ring cache, O(window) memory) must produce the
    exact greedy tokens of the full-cache generate() on a windowed model,
    including prompts longer than the window."""
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     window=4, pos_emb="rope")
    params = PRM.init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 7)))  # T0 > W
    full = G.generate(params, prompt, cfg, max_new=6,
                      key=jax.random.PRNGKey(0), temperature=0.0)
    ring = G.generate_streaming(params, prompt, cfg, max_new=6,
                                key=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(ring))


def test_streaming_generates_past_max_seq_len_with_rope():
    """With rope there is no wpe table to run off the end of: the ring cache
    generates sequences LONGER than cfg.max_seq_len — impossible for both
    the dense cache and the reference (wpe = max_seq_len cap).  Parity
    oracle: the dense path evaluated under a config whose max_seq_len is
    enlarged (wpe is never read in rope mode, so the same weights apply)."""
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     window=4, pos_emb="rope")         # max_seq_len = 16
    params = PRM.init_params(cfg, jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 5)))
    total_new = 30                                      # 5 + 30 > 16
    ring = G.generate_streaming(params, prompt, cfg, max_new=total_new,
                                key=jax.random.PRNGKey(0), temperature=0.0)
    assert ring.shape == (1, 35)
    big = cfg.replace(max_seq_len=64)
    full = G.generate(params, prompt, big, max_new=total_new,
                      key=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(np.asarray(ring), np.asarray(full))
    # ring memory is O(window), not O(T)
    caches = G.init_ring_kv(cfg, 1, chunk=5)
    assert caches[0].shape[2] == cfg.window + 5


def test_streaming_ring_int8_weights_track_float():
    """The ring path must dequantize weight-only int8 params like every
    other decode path (code-review r3 finding: the '_scale' leaves were
    dropped from the ring block dict)."""
    from vitrs_tpu.ops import quant
    cfg = get_config("gpt-nano", use_flash=False, num_heads=4, channels=32,
                     window=4, pos_emb="rope")
    params = PRM.init_params(cfg, jax.random.PRNGKey(7))
    qparams = quant.quantize_params(params, mode="gpt")
    assert "qkvw_scale" in qparams          # int8 path actually engaged
    rng = np.random.default_rng(7)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 6)))
    full = G.generate_streaming(params, prompt, cfg, max_new=6,
                                key=jax.random.PRNGKey(0), temperature=0.0)
    q = G.generate_streaming(qparams, prompt, cfg, max_new=6,
                             key=jax.random.PRNGKey(0), temperature=0.0)
    # int8 weight quantization perturbs logits slightly; most greedy tokens
    # must still agree (garbage-int8 decoding would agree on none)
    agree = float(np.mean(np.asarray(full) == np.asarray(q)))
    assert agree >= 0.75, agree


def test_window_flops_accounting():
    cfg = get_config("gpt2-124m")
    full = flops.forward_flops_per_example(cfg)
    win = flops.forward_flops_per_example(cfg.replace(window=256))
    assert win < full
    # difference is exactly the attention band shrink: 4*T*(T-W)*C per layer
    T, W, Ch, L = 1024, 256, 768, 12
    np.testing.assert_allclose(full - win, 4 * T * (T - W) * Ch * L)
