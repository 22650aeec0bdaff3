"""Muon — MomentUm Orthogonalized by Newton-Schulz (Jordan et al., 2024).

Beyond-reference optimizer (the reference ships SGD with dormant m/v
buffers, SURVEY §2.9 G7; this framework's production default is fused
AdamW).  Muon is the optimizer behind the current llm.c/nanoGPT GPT-2
speedrun records: for each 2-D weight it replaces the elementwise Adam
update with the nearest-orthogonal matrix of the momentum buffer,
approximated by a quintic Newton-Schulz iteration.

Why it suits a matmul machine: the NS iteration is FIVE batched matmuls
per weight per step — pure tensor-core work in bf16 (the iteration is
stable in bf16 by construction; Jordan runs it in bf16 on GPUs).  On the
stacked (L, OC, IC) parameter layout (params.py) the whole depth
orthogonalizes as ONE batched matmul chain, no per-layer dispatch.

Hybrid policy (the standard recipe): Muon for the per-layer matrices
(qkvw / attprojw / fcw / fcprojw), AdamW for everything else (embeddings,
LN gains/biases, biases, head).  Update scale follows Jordan's
`max(1, rows/cols)**0.5` aspect compensation.

Usage:
    state = muon.init_state(params)
    params, state, = muon.step(params, grads, state, step, lr, ...)
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import optimizer as opt

# the per-layer 2-D matrices Muon owns; everything else goes to AdamW.
# (wte/headw are matrices too, but embeddings/heads are the documented
# exception in the Muon recipe — they stay on AdamW.)
MUON_KEYS = ("qkvw", "attprojw", "fcw", "fcprojw", "patchw")

# quintic Newton-Schulz coefficients (Jordan's tuned values: maximize the
# slope at 0 while keeping the fixed-point interval tight around 1)
_NS_A, _NS_B, _NS_C = 3.4445, -4.7750, 2.0315


def newton_schulz5(g: jax.Array, steps: int = 5,
                   eps: float = 1e-7) -> jax.Array:
    """Approximate UVᵀ of the SVD of g (..., n, m) — the nearest
    semi-orthogonal matrix.  Runs in bf16 (stable by construction: the
    iteration only needs the singular values to land in ~[0.7, 1.2], not
    machine-precision orthogonality)."""
    x = g.astype(jnp.bfloat16)
    tall = x.shape[-2] > x.shape[-1]
    if tall:
        x = jnp.swapaxes(x, -1, -2)
    norm = jnp.sqrt(jnp.sum(jnp.square(x.astype(jnp.float32)),
                            axis=(-2, -1), keepdims=True)) + eps
    x = (x.astype(jnp.float32) / norm).astype(jnp.bfloat16)
    for _ in range(steps):
        a = x @ jnp.swapaxes(x, -1, -2)
        b = _NS_B * a + _NS_C * (a @ a)
        x = _NS_A * x + b @ x
    if tall:
        x = jnp.swapaxes(x, -1, -2)
    return x


class MuonState(NamedTuple):
    momentum: Dict[str, jax.Array]        # Muon leaves
    m: Dict[str, jax.Array]               # AdamW first moment (other leaves)
    v: Dict[str, jax.Array]               # AdamW second moment


def split_muon(params: Dict[str, jax.Array]) -> Tuple[Dict, Dict]:
    """(muon_leaves, adamw_leaves) by the hybrid policy."""
    muon = {k: v for k, v in params.items() if k in MUON_KEYS}
    rest = {k: v for k, v in params.items() if k not in MUON_KEYS}
    return muon, rest


def init_state(params: Dict[str, jax.Array]) -> MuonState:
    muon, rest = split_muon(params)
    z = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return MuonState(momentum=z(muon), m=z(rest), v=z(rest))


def step(params: Dict[str, jax.Array], grads: Dict[str, jax.Array],
         state: MuonState, step_i: jax.Array, lr: float,
         momentum: float = 0.95, nesterov: bool = True,
         adamw_lr: float = None, weight_decay: float = 0.0,
         ns_steps: int = 5):
    """One hybrid Muon/AdamW step.  lr is the Muon learning rate (a good
    default is ~0.02 at GPT-2 scale — an order of magnitude above Adam's);
    adamw_lr defaults to lr * 0.15 if not given.  weight_decay applies
    decoupled on the Muon matrices and via AdamW's own decay elsewhere."""
    if adamw_lr is None:
        adamw_lr = lr * 0.15
    muon_p, rest_p = split_muon(params)
    muon_g = {k: grads[k] for k in muon_p}
    rest_g = {k: grads[k] for k in rest_p}

    new_mom, new_p = {}, {}
    for k, g in muon_g.items():
        gf = g.astype(jnp.float32)
        buf = momentum * state.momentum[k] + gf
        eff = gf + momentum * buf if nesterov else buf
        o = newton_schulz5(eff, steps=ns_steps).astype(jnp.float32)
        # aspect compensation: rows/cols of the 2-D matrix (last two dims
        # of the stacked (L, OC, IC) layout)
        scale = max(1.0, eff.shape[-2] / eff.shape[-1]) ** 0.5
        p = muon_p[k].astype(jnp.float32)
        if weight_decay:
            p = p * (1.0 - lr * weight_decay)
        new_p[k] = (p - lr * scale * o).astype(muon_p[k].dtype)
        new_mom[k] = buf
    rest_new, m, v = opt.adamw_tree(rest_p, rest_g, state.m, state.v,
                                    step_i, adamw_lr,
                                    weight_decay=weight_decay,
                                    decay_mask=opt.decay_mask_2d(rest_p))
    new_p.update(rest_new)
    return new_p, MuonState(momentum=new_mom, m=m, v=v)


@functools.partial(jax.jit, static_argnames=("cfg", "lr", "momentum",
                                             "weight_decay"))
def muon_train_step(params, state: MuonState, step_i, inputs, targets, cfg,
                    lr: float = 0.02, momentum: float = 0.95,
                    weight_decay: float = 0.0):
    """Fused loss+grad+update step (gpt or vit mode via cfg)."""
    from ..models import model as M
    loss, g = jax.value_and_grad(M.loss_fn)(params, inputs, targets, cfg)
    params, state = step(params, g, state, step_i + 1, lr,
                         momentum=momentum, weight_decay=weight_decay)
    return loss, params, state
