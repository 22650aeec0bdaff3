"""Mixture-of-Experts MLP — top-k token routing with static capacity.

The reference's MLP is a single dense fc/fcproj pair per layer
(/root/reference/rusty_vit.rs:112-117 fcw/fcprojw, consumed at
rusty_vit.rs:326-328); MoE is the beyond-reference scaling axis: L layers of
E experts each, only top_k of which run per token, so parameter count grows
~E× while per-token FLOPs stay ~top_k× the dense MLP.

Design (everything is static-shaped and jit-traceable):

  * routing:   one (S, E) fp32 router matmul + `lax.top_k`; the per-expert
               slot assignment is a cumulative-sum over a one-hot assignment
               matrix — no data-dependent shapes, no host round trips.
  * dispatch:  a single scatter (`.at[dst].set(..., mode='drop')`) into a
               dense (E·cap, C) buffer; tokens routed past an expert's
               capacity are dropped (their combine weight contributes 0),
               exactly the Switch/GShard static-capacity contract.
  * experts:   ONE batched dot_general over the stacked (E, 4C, C) /
               (E, C, 4C) expert weights — E independent matmuls become a
               single batched contraction, fp32-accumulated
               like every other matmul in the framework (ops/basic.linear).
  * combine:   a gather back to token order (`jnp.take(..., mode='fill')`)
               weighted by the renormalized top-k router probabilities,
               accumulated in fp32.

Priority order for capacity is k-major (all first choices across the batch
claim slots before any second choice), the Switch transformer rule — a
token's top-1 assignment is never evicted by another token's top-2.

Auxiliary losses returned to the caller (weighted in models/model.gpt_loss):
  * load-balance (Switch eq. 4 generalized to top-k): E · Σ_e f_e · P_e
    where f_e is the fraction of the S·K assignments routed to expert e and
    P_e the mean router probability; equals 1.0 at perfect uniformity.
  * router z-loss (ST-MoE): mean(logsumexp(logits)²), keeps router logits
    from drifting large and saturating the softmax.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Constant-substitution attribution knobs (TIMING ONLY — wrong math, same
# shapes; the ROPE_DIAG method, benchmarks/moe_attribution.py):
#   "fixedroute"  replace the whole routing chain (fp32 router matmul,
#                 softmax, top_k, one-hot cumsum, aux) with a static
#                 round-robin slot map -> measures the routing-chain cost
#   "nogather"    replace the dispatch/combine row gathers with same-shape
#                 linear copies -> measures the gather traffic cost
MOE_DIAG = os.environ.get("VITRS_MOE_DIAG", "")
# Round-5 gather-coalescing experiment: fold each K-loop of row gathers
# into ONE take over the flattened (K·S,) index (same bytes, 1/K the ops)
# — the attribution measured the gathers at 24.7 ms/step (3.4x their
# bandwidth roofline) at 8e top-2 B=24.
BATCHED_GATHER = os.environ.get("VITRS_MOE_BATCHED_GATHER", "0") == "1"


class MoEAux(NamedTuple):
    """Router health: auxiliary losses + occupancy diagnostic."""
    load_balance: jax.Array   # scalar, 1.0 at uniform routing
    z_loss: jax.Array         # scalar, mean squared router logsumexp
    # fraction of the S·top_k assignments that fit within capacity (1.0 = no
    # token dropped); diagnostic only — NOT differentiable routing signal
    kept_fraction: jax.Array


def capacity(num_tokens: int, num_experts: int, top_k: int,
             cap_factor: float) -> int:
    """Static per-expert slot count: ceil(S·K/E · factor), rounded up to a
    multiple of 8 rows for the (E, cap, C) dispatch buffer."""
    import math
    cap = math.ceil(num_tokens * top_k * cap_factor / num_experts)
    cap = max(cap, 8)
    return -(-cap // 8) * 8


def router(x_flat: jax.Array, routerw: jax.Array, top_k: int,
           cap: int) -> Tuple[jax.Array, jax.Array, jax.Array, MoEAux]:
    """Route S tokens to top_k of E experts under a static capacity.

    Returns (dst, weight, keep, aux):
      dst    (K, S) i32 — flat slot index into the (E·cap) dispatch buffer;
                           E·cap (one past the end) where the token was
                           dropped, so scatter mode='drop' discards it.
      weight (K, S) f32 — renormalized top-k router probability (mass of
                           dropped assignments is lost, the standard
                           static-capacity behavior).
      keep   (K, S) bool — assignment fit within capacity.
    """
    S, _ = x_flat.shape
    E = routerw.shape[0]
    K = top_k
    # router always in fp32: the softmax over experts is the load-bearing
    # decision — bf16 logits visibly perturb top-k order at init
    logits = jax.lax.dot_general(
        x_flat.astype(jnp.float32), routerw.astype(jnp.float32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)            # (S, E)
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, K)               # (S, K)
    weight = (topv / jnp.sum(topv, axis=-1, keepdims=True)).T   # (K, S)

    # slot assignment: one-hot over experts, k-major priority order
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.int32)  # (S, K, E)
    oh_km = onehot.transpose(1, 0, 2).reshape(K * S, E)
    # 0-based position of each assignment within its expert's queue
    pos = (jnp.cumsum(oh_km, axis=0) - 1) * oh_km      # (K·S, E)
    slot = jnp.sum(pos.reshape(K, S, E), axis=-1)      # (K, S)
    expert = topi.T                                    # (K, S)
    keep = slot < cap
    dst = jnp.where(keep, expert * cap + slot, E * cap)

    # aux: fraction-of-assignments × mean-probability per expert
    f = jnp.mean(oh_km.astype(jnp.float32), axis=0)    # (E,)
    p_mean = jnp.mean(probs, axis=0)                   # (E,)
    lb = E * jnp.sum(f * p_mean)
    zl = jnp.mean(jnp.square(jax.scipy.special.logsumexp(logits, axis=-1)))
    aux = MoEAux(lb, zl, jnp.mean(keep.astype(jnp.float32)))
    return dst, weight, keep, aux


# --- gather-only dispatch/combine -------------------------------------------
#
# The slot assignment is an INJECTIVE partial map (token, k) <-> slot, so
# with both directions of the index map materialized — dst (K, S): slot per
# assignment, and inv (E·cap,): flat k-major assignment index per slot
# (K·S for empty slots) — every data movement in BOTH the forward and the
# backward is a row GATHER:
#
#   dispatch fwd:  buf[slot]  = xs[tok(inv[slot])]            gather at inv
#   dispatch bwd:  dxs[s]     = Σ_k dbuf[dst[k, s]]           gather at dst
#   combine  fwd:  out[s]     = Σ_k w[k, s] · ys[dst[k, s]]   gather at dst
#   combine  bwd:  dys[slot]  = w[inv[slot]] · dout[tok]      gather at inv
#                  dw[k, s]   = <dout[s], ys[dst[k, s]]>      gather at dst
#
# The previous formulation scattered (S, C) rows into the slot buffer
# (`.at[dst].set`), whose transpose is a scatter-add — an op class whose
# per-layer graph dominated MoE compile time
# (measured on the CPU backend at 8 layers: row-scatter dispatch chain 142 s
# vs 74 s for the index form; the router cumsum itself compiles in ~1 s).
# Here the only scatter left anywhere is the (K·S,)-int32 build of inv.
# Dropped assignments ride mode='fill': dst = E·cap lands out of range on a
# (E·cap,) take (contributes 0), empty slots' inv = K·S maps to token row S
# (out of range on a (S,) take — zero rows in, zero cotangents out).

def build_inverse(dst: jax.Array, E: int, cap: int) -> jax.Array:
    """(K, S) slot map -> (E·cap,) flat k-major assignment index per slot
    (K·S where the slot is empty).  The single (tiny, int32) scatter of the
    dispatch path."""
    K, S = dst.shape
    return jnp.full((E * cap,), K * S, jnp.int32).at[
        dst.reshape(K * S)].set(jnp.arange(K * S, dtype=jnp.int32),
                                mode="drop")


def _slot_tok(inv: jax.Array, K: int, S: int) -> jax.Array:
    """Slot -> source token row; empty slots -> S (out-of-range => fill)."""
    return jnp.where(inv < K * S, inv % S, S)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def dispatch(xs, inv, dst, E_cap, S):
    """xs (S, C) -> buf (E·cap, C) by gather at inv; VJP gathers at dst."""
    K = dst.shape[0]
    return jnp.take(xs, _slot_tok(inv, K, S), axis=0, mode="fill",
                    fill_value=0)


def _dispatch_fwd(xs, inv, dst, E_cap, S):
    return dispatch(xs, inv, dst, E_cap, S), (dst,)


def _dispatch_bwd(E_cap, S, res, dbuf):
    (dst,) = res
    if BATCHED_GATHER:
        K, S_ = dst.shape
        g = jnp.take(dbuf, dst.reshape(K * S_), axis=0, mode="fill",
                     fill_value=0)
        dxs = jnp.sum(g.reshape(K, S_, -1), axis=0)
    else:
        dxs = sum(jnp.take(dbuf, dst[k], axis=0, mode="fill", fill_value=0)
                  for k in range(dst.shape[0]))
    return dxs, None, None


dispatch.defvjp(_dispatch_fwd, _dispatch_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def combine(ys, weight, inv, dst, S):
    """out[s] = Σ_k weight[k, s] · ys[dst[k, s]] in fp32; VJP is gathers
    both ways (see module note)."""
    if BATCHED_GATHER:
        K = dst.shape[0]
        g = jnp.take(ys, dst.reshape(K * S), axis=0, mode="fill",
                     fill_value=0).reshape(K, S, -1)
        return jnp.sum(weight[:, :, None] * g.astype(jnp.float32), axis=0)
    out = jnp.zeros((S, ys.shape[-1]), jnp.float32)
    for k in range(dst.shape[0]):
        g = jnp.take(ys, dst[k], axis=0, mode="fill", fill_value=0)
        out = out + weight[k][:, None] * g.astype(jnp.float32)
    return out


def _combine_fwd(ys, weight, inv, dst, S):
    return combine(ys, weight, inv, dst, S), (ys, weight, inv, dst)


def _combine_bwd(S, res, dout):
    ys, weight, inv, dst = res
    K = dst.shape[0]
    tok = _slot_tok(inv, K, S)
    # per-slot combine weight: gather the flat (K·S,) weight at inv
    wflat = jnp.take(weight.reshape(K * S), inv, mode="fill", fill_value=0)
    dys = (wflat[:, None]
           * jnp.take(dout, tok, axis=0, mode="fill", fill_value=0)
           ).astype(ys.dtype)
    if BATCHED_GATHER:
        g = jnp.take(ys, dst.reshape(K * S), axis=0, mode="fill",
                     fill_value=0).reshape(K, S, -1)
        dw = jnp.sum(dout[None] * g.astype(jnp.float32), axis=-1)
    else:
        dw = jnp.stack([
            jnp.sum(dout * jnp.take(ys, dst[k], axis=0, mode="fill",
                                    fill_value=0).astype(jnp.float32),
                    axis=-1)
            for k in range(K)])
    return dys, dw, None, None


combine.defvjp(_combine_fwd, _combine_bwd)


def _expert_ffn(xe: jax.Array, fcw: jax.Array, fcb: jax.Array,
                fcprojw: jax.Array, fcprojb: jax.Array,
                erf: bool, tp_axis=None) -> jax.Array:
    """Batched expert MLP: (E, cap, C) → (E, cap, C) in two batched
    dot_generals (E is a batch dim → one batched matmul, not E).

    tp_axis: Megatron tensor parallelism INSIDE each expert — fcw/fcb
    arrive column-sharded on 4C (local (E_loc, 4C/tp, C)), fcprojw
    row-sharded on its 4C input; the conjugate collectives (copy_in /
    reduce_out, parallel/tensor_parallel.py:51-87) make the activation
    gradients exact, the same contract as the dense TP block."""
    from . import basic
    dt = xe.dtype
    if tp_axis is not None:
        from ..parallel.tensor_parallel import copy_in
        xe = copy_in(xe, tp_axis)
    h = jax.lax.dot_general(
        xe, fcw.astype(dt),
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(dt)  # (E, cap, 4C[/tp])
    h = h + fcb.astype(dt)[:, None, :]
    hg = basic.gelu_erf_cv(h) if erf else basic.gelu_cv(h)
    y = jax.lax.dot_general(
        hg, fcprojw.astype(dt),
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(dt)  # (E, cap, C)
    if tp_axis is not None:
        from ..parallel.tensor_parallel import reduce_out
        y = reduce_out(y, tp_axis)
    return y + fcprojb.astype(dt)[:, None, :]


def moe_mlp(x: jax.Array, routerw: jax.Array, fcw: jax.Array, fcb: jax.Array,
            fcprojw: jax.Array, fcprojb: jax.Array, *, top_k: int,
            cap_factor: float, erf: bool = False,
            ep_axis=None, ep: int = 1, tp_axis=None
            ) -> Tuple[jax.Array, MoEAux]:
    """The MoE replacement for the dense MLP branch.

    x (B, T, C) or (S, C); expert-stacked weights routerw (E, C),
    fcw (E, 4C, C), fcb (E, 4C), fcprojw (E, C, 4C), fcprojb (E, C) — the
    per-expert (OC, C) row-major convention of every matmul in the framework
    (rusty_vit.rs:484-498).  Returns (out, aux) with out shaped like x.

    Expert parallelism (inside shard_map): ep_axis names the mesh axis over
    which the E axis of the expert weights is sharded (fcw et al. arrive as
    the LOCAL (E/ep, ...) shard; routerw stays replicated — it is tiny and
    every token must score every expert).  The dispatch buffer makes one
    `all_to_all` hop out — each device sends the slots bound for
    other devices' experts and receives every ep-peer's slots for its own —
    and one hop home after the expert FFN.  Per-device expert FLOPs and
    weight memory scale 1/ep; the wire cost is 2·(E·cap·C)/ep per device,
    the canonical GShard dispatch pattern.

    tp_axis (composable with ep_axis — GShard's deployment shape): each
    expert's FFN is additionally Megatron-sharded over `tp_axis`; routing
    and dispatch stay replicated on that axis (deterministic, so every
    model shard computes identical dst/weight), only the expert matmuls
    split.  See _expert_ffn.
    """
    orig_shape = x.shape
    C = orig_shape[-1]
    xs = x.reshape(-1, C)
    S = xs.shape[0]
    E = routerw.shape[0]
    if ep_axis is not None:
        assert E % ep == 0 and fcw.shape[0] == E // ep, (E, ep, fcw.shape)
    cap = capacity(S, E, top_k, cap_factor)

    if MOE_DIAG == "fixedroute":     # timing isolation only
        K = top_k
        a = jnp.arange(K * S, dtype=jnp.int32)
        dst = (a % (E * cap)).reshape(K, S)
        weight = jnp.full((K, S), 1.0 / K, jnp.float32)
        aux = MoEAux(*(jnp.zeros((), jnp.float32),) * 3)
    else:
        dst, weight, keep, aux = router(xs, routerw, top_k, cap)

    # dispatch: gather-only (see the gather-only dispatch/combine note) —
    # inv inverts the slot map once, then tokens flow to their slots by a
    # row gather whose VJP is also a row gather
    if MOE_DIAG == "nogather":       # timing isolation only
        reps = -(-(E * cap) // S)
        buf = jnp.tile(xs, (reps, 1))[:E * cap]
        inv = dst = None
    else:
        inv = build_inverse(dst, E, cap)
        buf = dispatch(xs, inv, dst, E * cap, S)
    if ep_axis is not None:
        # (E, cap, C) -> (E/ep, ep·cap, C): device e receives every peer's
        # slot block for ITS experts, stacked along the slot axis
        be = jax.lax.all_to_all(buf.reshape(E, cap, C), ep_axis,
                                split_axis=0, concat_axis=1, tiled=True)
        y = _expert_ffn(be, fcw, fcb, fcprojw, fcprojb, erf, tp_axis)
        # inverse hop: every peer's output slots come home
        y = jax.lax.all_to_all(y, ep_axis, split_axis=1, concat_axis=0,
                               tiled=True)
    else:
        y = _expert_ffn(buf.reshape(E, cap, C), fcw, fcb, fcprojw, fcprojb,
                        erf, tp_axis)

    # combine: gather expert outputs back to token order, weight, sum over k
    if MOE_DIAG == "nogather":       # timing isolation only
        out = y.reshape(E * cap, C)[:S].astype(jnp.float32) / top_k
    else:
        out = combine(y.reshape(E * cap, C), weight, inv, dst, S)
    return out.astype(x.dtype).reshape(orig_shape), aux


def dense_equivalent(x: jax.Array, routerw: jax.Array, fcw: jax.Array,
                     fcb: jax.Array, fcprojw: jax.Array, fcprojb: jax.Array,
                     *, top_k: int, erf: bool = False) -> jax.Array:
    """Capacity-free oracle: every token runs ALL experts densely, combined
    by the same renormalized top-k weights.  O(S·E) FLOPs — test-only; the
    dispatch path must match this exactly whenever nothing is dropped."""
    from . import basic
    C = x.shape[-1]
    xs = x.reshape(-1, C)
    logits = xs.astype(jnp.float32) @ routerw.astype(jnp.float32).T
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, top_k)
    w_full = jnp.zeros_like(probs)
    for k in range(top_k):
        w_full = w_full + jax.nn.one_hot(topi[:, k], probs.shape[-1],
                                         dtype=jnp.float32) * (
            topv[:, k] / jnp.sum(topv, axis=-1))[:, None]
    outs = []
    for e in range(routerw.shape[0]):
        h = basic.linear(xs, fcw[e], fcb[e])
        hg = basic.gelu_erf(h) if erf else basic.gelu(h)
        outs.append(basic.linear(hg, fcprojw[e], fcprojb[e]))
    stack = jnp.stack(outs, axis=1).astype(jnp.float32)   # (S, E, C)
    out = jnp.sum(w_full[..., None] * stack, axis=1)
    return out.astype(x.dtype).reshape(x.shape)
