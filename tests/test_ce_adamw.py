"""The padded-vocab cross-entropy and the AdamW update that the trainer's
hot path runs as plain jnp (XLA fuses both), against their references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import basic
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.oracle import numpy_ref as oracle


@pytest.mark.parametrize("v,want", [(1, 128), (127, 128), (128, 128),
                                    (129, 256), (50257, 50304)])
def test_pad_vocab(v, want):
    assert basic.pad_vocab(v) == want


@pytest.mark.parametrize("V", [11, 100, 129, 300])
def test_padded_ce_equals_unpadded(V):
    """Loss and gradient over the real columns equal the unpadded CE; the
    pad columns get zero gradient."""
    Vp = basic.pad_vocab(V)
    rng = np.random.default_rng(V)
    logits = jnp.asarray(rng.standard_normal((3, 5, V)) * 3, jnp.float32)
    pad = jnp.asarray(rng.standard_normal((3, 5, Vp - V)) * 3, jnp.float32)
    targets = jnp.asarray(rng.integers(0, V, (3, 5)))

    def padded(lg):
        return jnp.mean(basic.cross_entropy_padded(lg, targets, V))

    def plain(lg):
        return jnp.mean(basic.cross_entropy_from_logits(lg, targets))

    full = jnp.concatenate([logits, pad], axis=-1)
    np.testing.assert_allclose(float(padded(full)), float(plain(logits)),
                               rtol=1e-6)
    g = np.asarray(jax.grad(padded)(full))
    np.testing.assert_allclose(g[..., :V], np.asarray(jax.grad(plain)(logits)),
                               rtol=1e-5, atol=1e-8)
    assert not np.any(g[..., V:])


def test_padded_ce_matches_oracle():
    rng = np.random.default_rng(6)
    V = 11
    logits = rng.standard_normal((2, 3, 128), dtype=np.float32) * 3
    targets = rng.integers(0, V, (2, 3))
    got = np.asarray(basic.cross_entropy_padded(
        jnp.asarray(logits), jnp.asarray(targets), V))
    want = oracle.crossentropy_forward(
        oracle.softmax_forward(logits[..., :V]), targets)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gpt_loss_padded_equals_unpadded_head():
    """gpt_loss (head padded to pad_vocab rows, pad columns masked) equals
    the plain unpadded head + CE: loss and every gradient."""
    cfg = get_config("gpt-nano", vocab_size=200)
    assert basic.pad_vocab(cfg.vocab_size) != cfg.vocab_size
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))

    def unpadded(p):
        logits = M.gpt_forward(p, x, cfg)
        return jnp.mean(basic.cross_entropy_from_logits(
            logits.astype(jnp.float32), y))

    lp, gp = jax.value_and_grad(M.gpt_loss)(params, x, y, cfg)
    lu, gu = jax.value_and_grad(unpadded)(params)
    np.testing.assert_allclose(float(lp), float(lu), rtol=1e-6)
    for k in gp:
        np.testing.assert_allclose(np.asarray(gp[k]), np.asarray(gu[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _adamw_reference(p, g, m, v, t, lr, b1, b2, eps, wd):
    """The llm.c AdamW update, in float64 numpy."""
    p, g, m, v = (np.asarray(a, np.float64) for a in (p, g, m, v))
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    return p - lr * (mhat / (np.sqrt(vhat) + eps) + wd * p), m, v


@pytest.mark.parametrize("t,wd", [(1, 0.0), (1, 0.1), (10, 0.01),
                                  (1000, 0.1)])
def test_adamw_step_matches_reference(t, wd):
    rng = np.random.default_rng(t)
    n = 1000
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = np.abs(rng.standard_normal(n) * 0.01).astype(np.float32)
    lr = 3e-4
    got = opt.adamw_step(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                         jnp.asarray(v), jnp.asarray(t, jnp.int32),
                         jnp.asarray(lr, jnp.float32), weight_decay=wd)
    want = _adamw_reference(p, g, m, v, t, lr, 0.9, 0.999, 1e-8, wd)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-5, atol=1e-7)


def test_adamw_tree_equals_flat_step():
    """The pytree form with the 2-D decay mask equals the flat update leaf
    by leaf (weight decay 0 where the mask is False)."""
    cfg = get_config("gpt-nano")
    params = PRM.init_params(cfg, jax.random.PRNGKey(1))
    grads = jax.tree.map(lambda a: a * 0.1 + 0.01, params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    step, lr = jnp.asarray(2, jnp.int32), jnp.asarray(1e-3, jnp.float32)
    mask = opt.decay_mask_2d(params)
    new_p, new_m, new_v = opt.adamw_tree(params, grads, zeros, zeros, step,
                                         lr, weight_decay=0.1,
                                         decay_mask=mask)
    for k in params:
        wd = 0.1 if mask[k] else 0.0
        p, m, v = opt.adamw_step(params[k], grads[k], zeros[k], zeros[k],
                                 step, lr, weight_decay=wd)
        np.testing.assert_allclose(np.asarray(new_p[k]), np.asarray(p),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(np.asarray(new_m[k]), np.asarray(m),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(np.asarray(new_v[k]), np.asarray(v),
                                   rtol=1e-6, err_msg=k)
