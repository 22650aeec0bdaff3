"""The attention op (ops/attention.py) vs the dense reference.

On the CPU the op runs `jax.nn.dot_product_attention` in XLA's form (the
rule in backend.attention_implementation); the reference is
ops/basic.attention_dense, the reference's materialized softmax(QKᵀ)V.
Values and gradients are held to it at the cells' head geometry (D=64), at
ViT's odd T=197, under GQA/MQA, rope and sliding windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import basic
from vitrs_tpu.ops.attention import (attention, expand_packed,
                                     fused_attention, split_gqa)

NH, D = 2, 64
C = NH * D


def _packed(B, T, num_heads, kv_heads, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    W = (num_heads + 2 * kv_heads) * D
    return jnp.asarray(rng.standard_normal((B, T, W)).astype(dtype))


def _dense(qkv, num_heads, kv_heads, causal, window=0):
    out, _ = basic.attention_dense(expand_packed(qkv, num_heads, kv_heads),
                                   num_heads, causal=causal, window=window)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 197, 256, 300])
def test_forward_matches_dense(T, causal):
    qkv = _packed(2, T, NH, NH, seed=T)
    got = attention(qkv, NH, causal=causal)
    want = _dense(qkv, NH, NH, causal)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [197, 256])
def test_grads_match_dense(T, causal):
    qkv = _packed(1, T, NH, NH, seed=7)

    def lf(x):
        return jnp.sum(jnp.sin(attention(x, NH, causal=causal)))

    def ld(x):
        return jnp.sum(jnp.sin(_dense(x, NH, NH, causal)))

    np.testing.assert_allclose(float(lf(qkv)), float(ld(qkv)), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(jax.grad(lf)(qkv)),
                               np.asarray(jax.grad(ld)(qkv)),
                               rtol=3e-4, atol=3e-5)


def test_bf16_inputs():
    """bf16 in, bf16 out, within bf16 rounding of the fp32 reference."""
    qkv = _packed(2, 128, NH, NH, seed=3)
    got = attention(qkv.astype(jnp.bfloat16), NH, causal=True)
    assert got.dtype == jnp.bfloat16
    want = _dense(qkv, NH, NH, True)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=3e-2, atol=3e-2)


def test_many_heads_of_64():
    """GPT-2's head geometry (12 x 64) at a short T."""
    H = 12
    qkv = _packed(1, 64, H, H, seed=5)
    np.testing.assert_allclose(np.asarray(attention(qkv, H, causal=True)),
                               np.asarray(_dense(qkv, H, H, True)),
                               rtol=2e-5, atol=2e-5)


def test_use_flash_false_is_the_dense_reference():
    qkv = _packed(2, 64, NH, NH, seed=9)
    got = attention(qkv, NH, causal=True, use_flash=False)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(_dense(qkv, NH, NH, True)))


def test_fused_attention_takes_unpacked_heads():
    """fused_attention's q/k/v entry equals the packed entry."""
    qkv = _packed(2, 32, 4, 2, seed=11)
    q, k, v = split_gqa(qkv, 4, 2)
    np.testing.assert_array_equal(
        np.asarray(fused_attention(q, k, v, 4, 2, causal=True)),
        np.asarray(attention(qkv, 4, causal=True, kv_heads=2)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KH", [(4, 2), (4, 1), (8, 4), (8, 2)])
def test_gqa_forward_matches_expanded_dense(H, KH, causal):
    """K/V at kv_heads heads (native GQA) == dense MHA over the K/V heads
    repeated per query group."""
    qkv = _packed(2, 96, H, KH, seed=H * 10 + KH)
    got = attention(qkv, H, causal=causal, kv_heads=KH)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_dense(qkv, H, KH, causal)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,KH", [(4, 2), (4, 1), (8, 4)])
def test_gqa_window_forward_matches_dense(H, KH):
    qkv = _packed(1, 160, H, KH, seed=40 + H + KH)
    got = attention(qkv, H, causal=True, window=40, kv_heads=KH)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(_dense(qkv, H, KH, True, window=40)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,KH", [(4, 2), (4, 1), (8, 4)])
def test_gqa_rope_matches_rotated_dense(H, KH):
    """rope=True rotates q/k inside the op at positions 0..T-1."""
    from vitrs_tpu.ops.rope import rope_qk
    T = 64
    qkv = _packed(2, T, H, KH, seed=60 + H + KH)
    q, k, v = split_gqa(qkv, H, KH)
    qr, kr = rope_qk(q, k, jnp.arange(T), H, KH)
    want = _dense(jnp.concatenate([qr, kr, v], -1), H, KH, True)
    got = attention(qkv, H, causal=True, rope=True, kv_heads=KH)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KH", [(4, 2), (4, 1), (8, 4)])
def test_gqa_grads_match_expanded_dense(H, KH, causal):
    """The GQA backward (dk/dv summed over each query group) equals the
    transpose of the dense path's K/V expansion."""
    qkv = _packed(1, 64, H, KH, seed=80 + H + KH)

    def lf(x):
        return jnp.sum(jnp.sin(attention(x, H, causal=causal, kv_heads=KH)))

    def ld(x):
        return jnp.sum(jnp.sin(_dense(x, H, KH, causal)))

    np.testing.assert_allclose(np.asarray(jax.grad(lf)(qkv)),
                               np.asarray(jax.grad(ld)(qkv)),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("mode", ["gpt", "vit"])
def test_model_loss_and_grads_fused_vs_dense(mode):
    """The whole model with the attention op (use_flash=True) vs the same
    model on the dense reference attention: loss and every gradient."""
    if mode == "gpt":
        cfg = get_config("gpt-nano", channels=128, num_heads=2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
        y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    else:
        cfg = get_config("vit-tiny-4-cifar10", num_layers=2, channels=128,
                         num_heads=2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((2, 32, 32, 3), dtype=np.float32))
        y = jnp.asarray(rng.integers(0, 10, (2,)))
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    lf, gf = jax.value_and_grad(M.loss_fn)(params, x, y, cfg)
    ld, gd = jax.value_and_grad(M.loss_fn)(params, x, y,
                                           cfg.replace(use_flash=False))
    np.testing.assert_allclose(float(lf), float(ld), rtol=1e-6)
    for k in gf:
        np.testing.assert_allclose(np.asarray(gf[k]), np.asarray(gd[k]),
                                   rtol=2e-4, atol=2e-6, err_msg=k)
