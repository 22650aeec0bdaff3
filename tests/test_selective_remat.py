"""Selective rematerialization (models/selective.py): gradient parity vs the
plain path, the branches vs a dense jnp oracle, what the attention branch
saves, and odd head counts (GPT-2 1.5B: 25)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.models import selective as S
from vitrs_tpu.ops import basic


def _grads_close(g1, g2, rtol=2e-4, atol=2e-5):
    flat1, t1 = jax.tree_util.tree_flatten(g1)
    flat2, t2 = jax.tree_util.tree_flatten(g2)
    assert t1 == t2
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# model-level: cfg.remat=True grads == cfg.remat=False grads (VERDICT r2 #1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gpt", "vit"])
def test_selective_remat_grads_match_plain(mode):
    if mode == "gpt":
        cfg = get_config("gpt-nano", use_flash=False)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
        y = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 16)))
    else:
        cfg = get_config("vit-tiny-4-cifar10", use_flash=False).replace(
            num_layers=2, channels=32, num_heads=2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((2, 32, 32, 3), dtype=np.float32))
        y = jnp.asarray(rng.integers(0, 10, (2,)))
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))

    def loss(p, c):
        return M.loss_fn(p, x, y, c)

    l0, g0 = jax.value_and_grad(loss)(params, cfg)
    l1, g1 = jax.value_and_grad(loss)(params, cfg.replace(remat=True))
    lf, gf = jax.value_and_grad(loss)(params, cfg.replace(remat="full"))
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(l0), float(lf), rtol=1e-6)
    _grads_close(g0, g1, rtol=1e-4, atol=1e-6)
    _grads_close(g0, gf, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# branch-level: the branches (fused attention op) vs dense jnp oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,T", [(True, 16), (False, 17)])
def test_attn_branch_flash_grads_match_dense(causal, T):
    C, H = 32, 2
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, T, C), dtype=np.float32))
    w = {
        "ln1w": jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1 + 1),
        "ln1b": jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
        "qkvw": jnp.asarray(rng.standard_normal((3 * C, C), dtype=np.float32) * 0.2),
        "qkvb": jnp.asarray(rng.standard_normal(3 * C, dtype=np.float32) * 0.1),
        "attprojw": jnp.asarray(rng.standard_normal((C, C), dtype=np.float32) * 0.2),
        "attprojb": jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
    }
    args = (x, w["ln1w"], w["ln1b"], w["qkvw"], w["qkvb"], w["attprojw"],
            w["attprojb"])

    def f_flash(*a):
        return jnp.sum(jnp.sin(S.attn_branch(*a, H, causal, True)))

    def f_ref(*a):
        return jnp.sum(jnp.sin(S._attn_ref(*a, num_heads=H, causal=causal)))

    np.testing.assert_allclose(float(f_flash(*args)), float(f_ref(*args)),
                               rtol=2e-5)
    _grads_close(jax.grad(f_flash, argnums=tuple(range(7)))(*args),
                 jax.grad(f_ref, argnums=tuple(range(7)))(*args),
                 rtol=3e-4, atol=3e-5)


def test_mlp_branch_grads_match_autodiff():
    C = 24
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 5, C), dtype=np.float32))
    args = (x,
            jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1 + 1),
            jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1),
            jnp.asarray(rng.standard_normal((4 * C, C), dtype=np.float32) * 0.2),
            jnp.asarray(rng.standard_normal(4 * C, dtype=np.float32) * 0.1),
            jnp.asarray(rng.standard_normal((C, 4 * C), dtype=np.float32) * 0.2),
            jnp.asarray(rng.standard_normal(C, dtype=np.float32) * 0.1))

    def ref(x, ln2w, ln2b, fcw, fcb, fcprojw, fcprojb):
        ln2, _, _ = basic.layernorm(x, ln2w, ln2b)
        return basic.linear(basic.gelu(basic.linear(ln2, fcw, fcb)),
                            fcprojw, fcprojb)

    def f_sel(*a):
        return jnp.sum(jnp.sin(S.mlp_branch(*a)))

    def f_ref(*a):
        return jnp.sum(jnp.sin(ref(*a)))

    np.testing.assert_allclose(float(f_sel(*args)), float(f_ref(*args)),
                               rtol=1e-6)
    _grads_close(jax.grad(f_sel, argnums=tuple(range(7)))(*args),
                 jax.grad(f_ref, argnums=tuple(range(7)))(*args),
                 rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# what the attention branch keeps, and odd head counts
# ---------------------------------------------------------------------------

def test_attn_branch_saves_attention_output_not_scores(capsys):
    """The checkpoint policy keeps the attention output and the LN stats
    besides the inputs; no qkv activation and no (B, H, T, T) score tensor
    is saved."""
    from jax.ad_checkpoint import print_saved_residuals
    B, T, C, H = 2, 16, 32, 2
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, T, C), dtype=np.float32))
    ws = [jnp.asarray(rng.standard_normal(s, dtype=np.float32) * 0.1)
          for s in ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,))]

    def f(x, *w):
        return jnp.sum(S.attn_branch(x, *w, H, True))

    print_saved_residuals(f, x, *ws)
    saved = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()
             if "from the argument" not in ln]
    assert sorted(saved) == ["f32[2,16,32]", "f32[2,16]", "f32[2,16]"], saved


def test_phantom_heads_match_dense_fwd_bwd():
    """3 heads of 64 (an odd head count) through the attention op equal
    dense attention on values and grads."""
    from vitrs_tpu.ops.attention import attention
    B, T, H, D = 2, 16, 3, 64
    C = H * D
    rng = np.random.default_rng(3)
    qkv = jnp.asarray(rng.standard_normal((B, T, 3 * C), dtype=np.float32))

    def f_fused(q):
        return jnp.sum(jnp.cos(attention(q, H, causal=True)))

    def f_dense(q):
        out, _ = basic.attention_dense(q, H, causal=True)
        return jnp.sum(jnp.cos(out))

    np.testing.assert_allclose(float(f_fused(qkv)), float(f_dense(qkv)),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(jax.grad(f_fused)(qkv)),
                               np.asarray(jax.grad(f_dense)(qkv)),
                               rtol=3e-4, atol=3e-5)


def test_1558m_head_geometry_takes_cudnn():
    """GPT-2 1.5B's 25 heads of 64 need no padding: the rule sends the
    bf16 shape to cuDNN on a GPU."""
    from vitrs_tpu import backend
    cfg = get_config("gpt2-1558m")
    assert cfg.num_heads == 25 and cfg.head_size == 64
    assert backend.attention_implementation(
        "gpu", "bfloat16", cfg.head_size, cfg.max_seq_len) == "cudnn"
