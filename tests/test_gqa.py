"""Grouped-query / multi-query attention (config.num_kv_heads).

Beyond-reference feature (the reference is MHA-only — rusty_vit.rs:512-563
always walks num_heads K/V heads).  Ground truth for every test is the
"replicated-MHA" construction: a GQA model is mathematically identical to an
MHA model whose K/V projection rows are replicated per query group, so loss,
logits, and gradients (with dk/dv group-summed) must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import checkpoint as CKPT
from vitrs_tpu import params as PRM
from vitrs_tpu.config import ViTConfig, get_config
from vitrs_tpu.models import generate as G
from vitrs_tpu.models import model as M
from vitrs_tpu.models import selective as S
from vitrs_tpu.ops.attention import expand_kv_heads, split_gqa


def _gqa_cfg(kv_heads, **kw):
    return get_config("gpt-nano", use_flash=False,
                      num_heads=4, channels=32,
                      num_kv_heads=kv_heads, **kw)


def _replicate_qkvw(params, cfg):
    """GQA params -> equivalent MHA params (K/V weight rows repeated per
    query group).  Returns (mha_params, mha_cfg)."""
    C, D = cfg.channels, cfg.head_size
    KH, G = cfg.kv_heads, cfg.num_heads // cfg.kv_heads
    L = cfg.num_layers
    w = params["qkvw"]                                  # (L, C+2*kvd, C)
    b = params["qkvb"]
    kvd = KH * D
    q_w, k_w, v_w = w[:, :C], w[:, C:C + kvd], w[:, C + kvd:]

    def rep_w(t):                                       # (L, kvd, C) -> (L, C, C)
        return jnp.repeat(t.reshape(L, KH, D, C), G, axis=1).reshape(L, C, C)

    def rep_b(t):
        return jnp.repeat(t.reshape(L, KH, D), G, axis=1).reshape(L, C)

    out = dict(params)
    out["qkvw"] = jnp.concatenate([q_w, rep_w(k_w), rep_w(v_w)], axis=1)
    out["qkvb"] = jnp.concatenate([b[:, :C], rep_b(b[:, C:C + kvd]),
                                   rep_b(b[:, C + kvd:])], axis=1)
    return out, cfg.replace(num_kv_heads=0)


def _group_sum(dk_full, cfg):
    """MHA dk/dv (L, C, C)-gradient -> GQA form: sum each query group's
    block rows onto the shared KV head."""
    L, C, D = cfg.num_layers, cfg.channels, cfg.head_size
    KH, G = cfg.kv_heads, cfg.num_heads // cfg.kv_heads
    return dk_full.reshape(L, KH, G, D, C).sum(axis=2).reshape(L, KH * D, C)


def test_param_shapes_and_count():
    cfg = _gqa_cfg(2)
    shapes = PRM.param_shapes(cfg)
    C, kvd = 32, 2 * 8
    assert shapes["qkvw"] == (cfg.num_layers, C + 2 * kvd, C)
    assert shapes["qkvb"] == (cfg.num_layers, C + 2 * kvd)
    # count shrinks by exactly the dropped K/V rows vs MHA
    mha = cfg.replace(num_kv_heads=0)
    diff = PRM.num_parameters(mha) - PRM.num_parameters(cfg)
    assert diff == cfg.num_layers * 2 * (C - kvd) * (C + 1)


def test_expand_kv_heads_group_mapping():
    # kv head g must serve query heads [g*G, (g+1)*G)
    B, T, KH, NH, D = 1, 2, 2, 4, 3
    kv = jnp.arange(B * T * KH * D, dtype=jnp.float32).reshape(B, T, KH * D)
    full = expand_kv_heads(kv, KH, NH).reshape(B, T, NH, D)
    small = kv.reshape(B, T, KH, D)
    for h in range(NH):
        np.testing.assert_array_equal(np.asarray(full[:, :, h]),
                                      np.asarray(small[:, :, h // (NH // KH)]))


@pytest.mark.parametrize("kv_heads", [2, 1])  # GQA and MQA
def test_gqa_loss_and_grads_match_replicated_mha(kv_heads):
    cfg = _gqa_cfg(kv_heads)
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    full_params, full_cfg = _replicate_qkvw(params, cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))

    lg, gg = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)
    lf, gf = jax.value_and_grad(M.gpt_loss)(full_params, x, y, full_cfg)
    np.testing.assert_allclose(float(lg), float(lf), rtol=1e-6)
    C = cfg.channels
    kvd = cfg.kv_dim
    for name in gg:
        if name == "qkvw":
            np.testing.assert_allclose(
                np.asarray(gg[name][:, :C]), np.asarray(gf[name][:, :C]),
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                np.asarray(gg[name][:, C:C + kvd]),
                np.asarray(_group_sum(gf[name][:, C:2 * C], cfg)),
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                np.asarray(gg[name][:, C + kvd:]),
                np.asarray(_group_sum(gf[name][:, 2 * C:], cfg)),
                rtol=1e-5, atol=1e-6)
        elif name != "qkvb":
            np.testing.assert_allclose(np.asarray(gg[name]),
                                       np.asarray(gf[name]),
                                       rtol=1e-5, atol=1e-6)


def test_gqa_selective_remat_grads_match_plain():
    cfg = _gqa_cfg(2)
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


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attn_branch_interpret_flash_vs_dense(causal):
    """The selective-remat branch under GQA (K/V at kv_heads heads in the
    attention op): forward + all 7 grads vs the dense GQA oracle, whose
    expansion's transpose is the group sum."""
    C, H, KH = 32, 2, 1
    D = C // H
    kvd = KH * D
    rng = np.random.default_rng(3)
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
        return jnp.sum(jnp.sin(S.attn_branch(*a, H, causal, True, KH)))

    def f_ref(*a):
        return jnp.sum(jnp.sin(S._attn_ref(*a, num_heads=H, causal=causal,
                                           kv_heads=KH)))

    np.testing.assert_allclose(float(f_flash(*args)), float(f_ref(*args)),
                               rtol=2e-5)
    gf = jax.grad(f_flash, argnums=tuple(range(7)))(*args)
    gr = jax.grad(f_ref, argnums=tuple(range(7)))(*args)
    for a, b in zip(gf, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=3e-5)


def test_gqa_cache_prefill_matches_full_forward():
    cfg = _gqa_cfg(2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 6)))
    caches = G.init_kv_cache(cfg, 2, 12)
    assert caches[0].shape[-1] == cfg.kv_dim       # the cache shrinks
    lg, _ = G.forward_with_cache(params, prompt, caches, 0, cfg)
    full = M.gpt_forward(params, prompt, cfg)
    np.testing.assert_allclose(np.asarray(lg), np.asarray(full),
                               rtol=2e-4, atol=1e-4)


def test_gqa_incremental_decode_matches_full_forward():
    cfg = _gqa_cfg(2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 5)))
    caches = G.init_kv_cache(cfg, 2, 5)
    got = []
    for t in range(5):
        lg, caches = G.forward_with_cache(params, prompt[:, t:t + 1], caches,
                                          t, cfg)
        got.append(np.asarray(lg[:, 0]))
    full = np.asarray(M.gpt_forward(params, prompt, cfg))
    np.testing.assert_allclose(np.stack(got, axis=1), full,
                               rtol=3e-4, atol=2e-4)


def test_gqa_generate_greedy_and_int8_cache():
    cfg = _gqa_cfg(2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 4)))
    out = G.generate(params, prompt, cfg, max_new=5,
                     key=jax.random.PRNGKey(0), temperature=0.0)
    assert out.shape == (2, 9)
    # greedy must equal argmax over the full recompute at every step
    seq = np.asarray(out)
    for t in range(4, 9):
        lg = M.gpt_forward(params, jnp.asarray(seq[:, :t]), cfg)
        np.testing.assert_array_equal(seq[:, t],
                                      np.asarray(jnp.argmax(lg[:, -1], -1)))
    # int8 KV cache: same argmax path at this scale
    out8 = G.generate(params, prompt, cfg, max_new=5,
                      key=jax.random.PRNGKey(0), temperature=0.0,
                      kv_int8=True)
    assert np.mean(np.asarray(out8) == seq) >= 0.8


def test_gqa_decode_step_multi_matches_cache_path():
    cfg = _gqa_cfg(2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 4)))
    Tmax = 8
    # slot-pool layout: (L, B=slots, Tmax, kv_dim)
    caches = G.init_kv_cache(cfg, 2, Tmax)
    lg0, caches = G.prefill_into_slot(params, prompt[0], caches, 0, cfg)
    nxt = jnp.argmax(lg0, -1)
    lg1, caches = G.decode_step_multi(
        params, jnp.asarray([nxt, 0]), caches,
        jnp.asarray([4, 0], jnp.int32), cfg)
    # reference: full forward over the 5-token sequence
    seq = jnp.concatenate([prompt, nxt[None, None]], axis=1)
    full = M.gpt_forward(params, seq, cfg)
    np.testing.assert_allclose(np.asarray(lg1[0]), np.asarray(full[0, -1]),
                               rtol=3e-4, atol=2e-4)


def test_gqa_paged_decode_matches_dense_slots():
    cfg = _gqa_cfg(2, max_seq_len=32)     # decode runs past one 16-row page
    params = PRM.init_params(cfg, jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    T0 = G.PAGE                                           # one full page
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (T0,)))
    paged = G.init_paged_kv(cfg, n_pages=4)
    assert paged[0].shape[-1] == cfg.kv_dim
    lgp, paged = G.prefill_into_pages(params, prompt, paged,
                                      jnp.asarray([1]), cfg)
    table = jnp.asarray([[1, 2]], jnp.int32)
    nxt = jnp.argmax(lgp, -1)
    lg1, _ = G.decode_step_paged(params, nxt[None], paged, table,
                                 jnp.asarray([T0], jnp.int32), cfg)
    seq = jnp.concatenate([prompt, nxt[None]])[None]
    full = M.gpt_forward(params, seq, cfg)
    np.testing.assert_allclose(np.asarray(lg1[0]), np.asarray(full[0, -1]),
                               rtol=3e-4, atol=2e-4)


def test_gqa_checkpoint_roundtrip(tmp_path):
    cfg = _gqa_cfg(2)
    params = PRM.init_params(cfg, jax.random.PRNGKey(7))
    path = str(tmp_path / "gqa.bin")
    CKPT.save_checkpoint(path, params, cfg)
    loaded, file_cfg, _ = CKPT.load_checkpoint(path)
    assert file_cfg.num_kv_heads == 2         # header round-trips the field
    assert file_cfg.kv_heads == 2
    for n in params:
        np.testing.assert_array_equal(np.asarray(params[n]),
                                      np.asarray(loaded[n]))


def test_gqa_vit_mode_forward_and_grad():
    cfg = ViTConfig(mode="vit", num_layers=2, num_heads=4, channels=32,
                    patch_size=4, img_size=16, num_classes=10,
                    max_seq_len=17, vocab_size=10, num_kv_heads=2,
                    use_flash=False).validate()
    params = PRM.init_params(cfg, jax.random.PRNGKey(8))
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 3), dtype=np.float32))
    y = jnp.asarray(rng.integers(0, 10, (2,)))
    logits = M.vit_forward(params, x, cfg)
    assert logits.shape == (2, 10)
    g = jax.grad(M.vit_loss)(params, x, y, cfg)
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in g.values())


def test_split_gqa_widths():
    cfg = _gqa_cfg(2)
    qkv = jnp.zeros((1, 3, cfg.qkv_dim))
    q, k, v = split_gqa(qkv, cfg.num_heads, cfg.kv_heads)
    assert q.shape[-1] == cfg.channels
    assert k.shape[-1] == v.shape[-1] == cfg.kv_dim
