"""Adafactor — sublinear-memory optimizer (Shazeer & Stern 2018).

The reference's optimizer story is SGD with dormant AdamW moments
(train_vit.rs:73-74, gap G7); this framework ships fused AdamW as the
production default (ops/optimizer.py).  Adafactor is the
alternative for when the OPTIMIZER STATE is the memory wall: instead of a
full second moment v (one fp32 copy of every parameter), matrix-shaped
parameters keep only per-row and per-column EMAs of g² — O(n+m) instead of
O(n·m).  At GPT-2 1.5B that collapses 6.2 GB of m/v (bf16) to ~3 MB of
factored state, freeing HBM for batch (the measured single-chip 1.5B row
in BASELINE.md is state-bound, not weight-bound).

Implementation notes (the standard formulation):
  * beta2 schedule: β2_t = 1 − t^−0.8 — debiasing-free (the paper's decay).
  * factored v̂ = (R ⊗ C) / mean(R): R row-EMA, C col-EMA of g² + eps1.
    A leaf factors only when BOTH trailing dims reach MIN_FACTOR (=128, the
    optax/T5X `min_dim_size_to_factor` convention) — true weight matrices
    factor, while biases/LN stacks like (L, 4C) or (L, E, 4C) keep a full
    elementwise v (rank-factoring across a stack axis is not a meaningful
    low-rank structure, and elementwise v is what makes the expert-parallel
    step exactly invariant to sharding the E axis).  Stacked layouts —
    (L, OC, IC) blocks and (L, E, OC, IC) expert slabs — factor over the
    LAST TWO dims, keeping the leading stack axes (each layer/expert matrix
    is its own factorization, exactly the per-matrix semantics).
  * update clipping: u ← u / max(1, RMS(u)/d) with d = 1.0 — the paper's
    replacement for global grad-norm clipping, applied per PARAMETER in the
    paper's sense: per trailing matrix for factored leaves, per trailing
    vector for non-factored ndim≥2 stacks, whole-tensor for true vectors.
    (Also the property that makes the step invariant to leading-axis
    sharding — the expert-parallel Adafactor mode depends on it.)
  * relative step size (optional, on by default like the paper): the
    caller's lr is multiplied by max(RMS(param), eps2) so one scalar works
    across embedding/matrix scales; RMS(param) at the same granularity as
    the clip.
  * first moment: OFF by default (the memory-saving configuration); set
    beta1 > 0 for momentum at one param-copy of extra state.
  * decoupled weight decay, masked to matrix-shaped leaves by the caller
    (ops/optimizer.decay_mask_2d — the llm.c policy).

All state is fp32; the update math never runs below fp32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

EPS1 = 1e-30     # inside-sqrt regularizer on g²
EPS2 = 1e-3      # RMS(param) floor for the relative step size
CLIP_D = 1.0
MIN_FACTOR = 128  # min trailing-dim size to rank-factor (optax convention)


class AdafactorState(NamedTuple):
    """Pytrees mirroring the params: vr/vc factored rows/cols (zeros-shaped
    (…, OC) / (…, IC) for ndim≥2 leaves), vf full second moment for vectors
    (zeros for factored leaves — kept shape-stable so the state is a plain
    pytree for checkpointing), m first moment (empty dict when beta1=0)."""
    vr: Dict[str, jax.Array]
    vc: Dict[str, jax.Array]
    vf: Dict[str, jax.Array]
    m: Dict[str, jax.Array]


def _factored(p: jax.Array, min_factor: int = MIN_FACTOR) -> bool:
    return p.ndim >= 2 and min(p.shape[-2:]) >= min_factor


def init_state(params: Dict[str, jax.Array], beta1: float = 0.0,
               min_factor: int = MIN_FACTOR) -> AdafactorState:
    vr, vc, vf = {}, {}, {}
    for k, p in params.items():
        if _factored(p, min_factor):
            vr[k] = jnp.zeros(p.shape[:-1], jnp.float32)       # (…, OC)
            vc[k] = jnp.zeros(p.shape[:-2] + p.shape[-1:], jnp.float32)
            vf[k] = jnp.zeros((), jnp.float32)
        else:
            vr[k] = jnp.zeros((), jnp.float32)
            vc[k] = jnp.zeros((), jnp.float32)
            vf[k] = jnp.zeros(p.shape, jnp.float32)
    m = ({k: jnp.zeros(p.shape, jnp.float32) for k, p in params.items()}
         if beta1 > 0.0 else {})
    return AdafactorState(vr, vc, vf, m)


def _rms(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.mean(jnp.square(x)))


def step(params: Dict[str, jax.Array], grads: Dict[str, jax.Array],
         state: AdafactorState, t: jax.Array, lr,
         beta1: float = 0.0, weight_decay: float = 0.0,
         decay_mask: Optional[Dict[str, bool]] = None,
         relative_step: bool = True, min_factor: int = MIN_FACTOR,
         shard_axes: Optional[Dict[str, Optional[int]]] = None,
         axis_name=None,
         factored: Optional[Dict[str, bool]] = None):
    """One Adafactor step over the parameter pytree.

    t is the 1-based step count (drives the β2 schedule); lr is the
    caller's schedule value (multiplied by RMS(param) when relative_step).
    Returns (new_params, new_state).

    shard_axes/axis_name (tensor parallelism inside shard_map): per-leaf
    entry -1 or -2 marks which of the TRAILING TWO dims is sharded over
    `axis_name` (None = unsharded).  The step then completes every mean
    that crosses the sharded dim with a pmean over the axis — GATHERED-
    stats semantics: the update equals the single-device Adafactor step
    exactly (up to the pmean's reduction order), resolving the sharded-dim
    factoring question the per-shard block alternative would change.
    Leading-axis (stack/expert) sharding needs NO entry — the per-trailing-
    matrix scalars already make that exactly invariant (see module doc).

    factored: per-leaf override of the _factored(min_factor) decision —
    under TP the LOCAL slice of a big matrix can fall below MIN_FACTOR
    (C/tp < 128), but the layout must be judged on GLOBAL shapes so it
    never depends on the mesh.
    """
    tf = jnp.maximum(t.astype(jnp.float32), 1.0)
    beta2 = 1.0 - tf ** -0.8

    def pmean_if(x, needed):
        return jax.lax.pmean(x, axis_name) if (needed and
                                               axis_name is not None) else x

    new_p, new_vr, new_vc, new_vf, new_m = {}, {}, {}, {}, {}
    for k, p in params.items():
        sd = (shard_axes or {}).get(k)
        fac = (factored[k] if factored is not None
               else _factored(p, min_factor))
        g = grads[k].astype(jnp.float32)
        g2 = jnp.square(g) + EPS1
        if fac:
            # sharded-dim completion: a mean over the sharded dim is a
            # pmean of equal-sized partial means (exact for equal shards)
            vr = beta2 * state.vr[k] + (1.0 - beta2) * pmean_if(
                jnp.mean(g2, axis=-1), sd == -1)
            vc = beta2 * state.vc[k] + (1.0 - beta2) * pmean_if(
                jnp.mean(g2, axis=-2), sd == -2)
            # v̂ = outer(vr, vc) / mean(vr) per trailing matrix; vr's last
            # dim is the -2 (row) dim of p, so it is sharded iff sd == -2
            denom = jnp.maximum(pmean_if(
                jnp.mean(vr, axis=-1, keepdims=True), sd == -2), EPS1)
            u = g * jax.lax.rsqrt(vr / denom)[..., None] \
                  * jax.lax.rsqrt(vc)[..., None, :]
            new_vr[k], new_vc[k] = vr, vc
            new_vf[k] = state.vf[k]
            # RMS scalars (update clip, relative step size) are PER TRAILING
            # MATRIX, the paper's unit of clipping (each weight matrix is
            # its own parameter there) — which also makes the step exactly
            # invariant to sharding stacked leaves on their leading batch
            # dims (the expert-parallel Adafactor mode relies on this:
            # every (L, E)-indexed matrix sees identical scalars whether it
            # lives on one device or an "expert" shard)
            rms_u = jnp.sqrt(pmean_if(
                jnp.mean(jnp.square(u), axis=(-2, -1), keepdims=True),
                sd is not None))
        else:
            vf = beta2 * state.vf[k] + (1.0 - beta2) * g2
            u = g * jax.lax.rsqrt(vf)
            new_vf[k] = vf
            new_vr[k], new_vc[k] = state.vr[k], state.vc[k]
            # per trailing VECTOR for stacked bias/LN leaves (each (l[, e])
            # slice is its own parameter), whole-tensor for true vectors
            rms_u = (jnp.sqrt(pmean_if(
                         jnp.mean(jnp.square(u), axis=-1, keepdims=True),
                         sd == -1))
                     if p.ndim >= 2 else _rms(u))
        u = u / jnp.maximum(1.0, rms_u / CLIP_D)
        if beta1 > 0.0:
            mu = beta1 * state.m[k] + (1.0 - beta1) * u
            new_m[k] = mu
            u = mu
        pf = p.astype(jnp.float32)
        if relative_step:
            if fac:
                rms_p = jnp.sqrt(pmean_if(
                    jnp.mean(jnp.square(pf), axis=(-2, -1), keepdims=True),
                    sd is not None))
            elif p.ndim >= 2:
                rms_p = jnp.sqrt(pmean_if(
                    jnp.mean(jnp.square(pf), axis=-1, keepdims=True),
                    sd == -1))
            else:
                rms_p = _rms(pf)
            alpha = lr * jnp.maximum(rms_p, EPS2)
        else:
            alpha = lr
        wd = weight_decay if (decay_mask is None or decay_mask[k]) else 0.0
        pf = pf - alpha * u - lr * wd * pf
        new_p[k] = pf.astype(p.dtype)
    return new_p, AdafactorState(new_vr, new_vc, new_vf, new_m)


def shard_axes_from_specs(params, pspecs, axis_name,
                          min_factor: int = MIN_FACTOR):
    """Derive the `step(shard_axes=...)` map from a PartitionSpec tree:
    -1/-2 when that trailing dim of the leaf carries `axis_name`, else
    None.  Leading-dim sharding (stacks, experts) maps to None — the step
    is already exactly invariant there."""
    out = {}
    for k, p in params.items():
        spec = tuple(pspecs[k]) + (None,) * (p.ndim - len(tuple(pspecs[k])))

        def has(entry):
            return (axis_name in entry if isinstance(entry, tuple)
                    else entry == axis_name)

        sd = None
        if p.ndim >= 2:
            if has(spec[-1]):
                sd = -1
            elif has(spec[-2]):
                sd = -2
        out[k] = sd
    return out


def state_specs(params, pspecs, min_factor: int = MIN_FACTOR):
    """PartitionSpecs for an AdafactorState given the params' specs: vr
    drops the last param dim, vc the second-to-last, full-v/momentum shard
    like the param, factored leaves' scalar vf placeholder is replicated."""
    from jax.sharding import PartitionSpec as P

    def pad(k, nd):
        s = tuple(pspecs[k])
        return s + (None,) * (nd - len(s))

    vr, vc, vf = {}, {}, {}
    for k, p in params.items():
        sp = pad(k, p.ndim)
        if _factored(p, min_factor):
            vr[k] = P(*sp[:-1])
            vc[k] = P(*(sp[:-2] + sp[-1:]))
            vf[k] = P()
        else:
            vr[k], vc[k] = P(), P()
            vf[k] = P(*sp)
    return AdafactorState(vr, vc, vf, {})


def state_bytes(state: AdafactorState) -> int:
    """Total optimizer-state footprint (the point of Adafactor)."""
    return sum(a.size * a.dtype.itemsize
               for tree in state
               for a in jax.tree_util.tree_leaves(tree))
