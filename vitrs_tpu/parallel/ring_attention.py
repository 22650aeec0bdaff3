"""Ring attention — TRAINABLE context parallelism over a device ring.

The reference has no long-context story at all (SURVEY.md §5.7: it
materializes full O(T²) buffers and is capped by the wpe table).  This module
shards the sequence over a mesh axis: KV shards rotate around the ring via
`jax.lax.ppermute` (neighbor-only point-to-point) while each device
accumulates its queries' attention over every block with online-softmax
statistics, as a flash-attention kernel does within one device.  After N-1
hops every query has seen every key.

Round 2 shipped the forward only; the backward here is the second ring pass
(VERDICT r2 next-step #3): each device recomputes its tiles' probabilities
from the saved per-row lse, accumulates dq locally, and accumulates dk/dv
into buffers that TRAVEL WITH the rotating kv block — after a full loop each
kv shard arrives home carrying the sum of every device's contribution.
Communication volume is 2× the forward (k, v, dk, dv rotate), the classic
ring-attention trade.

`make_cp_train_step` wires the op into a full dp×cp GPT training step
(batch sharded on "data", sequence sharded on "ctx", ZeRO-1 optimizer state
sharded over ALL devices via nested reduce-scatters) — gradient-verified
against the single-device step in tests/test_ring_attention.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..config import ViTConfig
from .. import params as PRM
from ..models import model as M
from ..ops import basic
from ..ops import optimizer as opt


def _block_attend(q, k, v, m, l, acc, q_off, k_off, sm_scale, causal,
                  window=0):
    """One online-softmax accumulation step against a rotated KV block.
    q: (B,H,Tq,D); k/v: (B,H,Tk,D); m/l: (B,H,Tq,1); acc: (B,H,Tq,D).
    window > 0 (causal only): query t sees keys in (t-window, t], the same
    band as basic.attention_dense."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * sm_scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        rows = q_off + jax.lax.broadcasted_iota(jnp.int32, (Tq, Tk), 0)
        cols = k_off + jax.lax.broadcasted_iota(jnp.int32, (Tq, Tk), 1)
        keep = cols <= rows
        if window:
            keep &= cols > rows - window
        s = jnp.where(keep, s, -jnp.inf)
    m_curr = jnp.max(s, axis=-1, keepdims=True)
    m_next = jnp.maximum(m, m_curr)
    # guard fully-masked rows (m_next == -inf)
    safe_m = jnp.where(jnp.isfinite(m_next), m_next, 0.0)
    alpha = jnp.where(jnp.isfinite(m), jnp.exp(m - safe_m), 0.0)
    p = jnp.exp(jnp.where(jnp.isfinite(s), s - safe_m, -jnp.inf))
    l_next = alpha * l + jnp.sum(p, axis=-1, keepdims=True)
    pv = jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v,
                    preferred_element_type=jnp.float32)
    acc_next = acc * alpha + pv
    return m_next, l_next, acc_next


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_hops(n, window, Tk):
    """Ring length: n hops dense; banded (sliding window), a query's oldest
    key is window-1 rows back = at most ceil((window-1)/Tk) shards behind,
    so the ring stops after that many extra hops — attention comm AND
    compute become O(window), not O(T)."""
    if not window:
        return n
    return min(n, (max(0, window - 1) + Tk - 1) // Tk + 1)


def _ring_fwd_scan(q, k, v, axis, n, causal, window=0):
    """Returns (out, lse) for the local query shard.

    k/v may carry FEWER heads than q (GQA: (B, KH, Tk, D) with KH | H) —
    only the small blocks rotate on the ring (link traffic / group size) and
    each step expands its resident block to full heads locally, which is
    numerically identical to expanding before the ring.  window > 0 runs
    the BANDED ring: only _ring_hops(...) neighbor blocks circulate."""
    B, H, Tq, D = q.shape
    KH = k.shape[1]
    G = H // KH
    sm_scale = 1.0 / (D ** 0.5)
    idx = jax.lax.axis_index(axis)
    Tk = k.shape[2]
    h = _ring_hops(n, window, Tk)
    m = jnp.full((B, H, Tq, 1), -jnp.inf, jnp.float32)
    l = jnp.zeros((B, H, Tq, 1), jnp.float32)
    acc = jnp.zeros((B, H, Tq, D), jnp.float32)
    q_off = idx * Tq

    def step(carry, hop):
        k_blk, v_blk, m, l, acc = carry
        src = (idx - hop) % n                # who this block came from
        kf = jnp.repeat(k_blk, G, axis=1) if G > 1 else k_blk
        vf = jnp.repeat(v_blk, G, axis=1) if G > 1 else v_blk
        m, l, acc = _block_attend(q, kf, vf, m, l, acc,
                                  q_off, src * Tk, sm_scale, causal, window)
        k_blk = jax.lax.ppermute(k_blk, axis, _ring_perm(n))
        v_blk = jax.lax.ppermute(v_blk, axis, _ring_perm(n))
        return (k_blk, v_blk, m, l, acc), None

    (k, v, m, l, acc), _ = jax.lax.scan(step, (k, v, m, l, acc),
                                        jnp.arange(h))
    inv = jnp.where(l == 0.0, 0.0, 1.0 / l)
    out = (acc * inv).astype(q.dtype)
    lse = jnp.where(l == 0.0, -jnp.inf, m + jnp.log(jnp.maximum(l, 1e-38)))
    return out, lse


def ring_attention_local(q, k, v, axis: str, n: int, causal: bool,
                         window: int = 0):
    """Per-shard ring attention with a hand-written VJP — call INSIDE a
    shard_map whose mesh has axis `axis` of size n.  q: (B, H, T/n, D);
    k/v: (B, H or KH, T/n, D) local shards (sequence sharded; KH < H = GQA,
    small blocks rotate).  window > 0 (causal) = banded ring.  Returns the
    local out shard."""
    assert causal or not window, "sliding-window attention is causal-only"
    return _ring_local(q, k, v, axis, n, causal, window)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def _ring_local(q, k, v, axis, n, causal, window):
    out, _ = _ring_fwd_scan(q, k, v, axis, n, causal, window)
    return out


def _ring_local_fwd(q, k, v, axis, n, causal, window):
    out, lse = _ring_fwd_scan(q, k, v, axis, n, causal, window)
    return out, (q, k, v, out, lse)


def _ring_local_bwd(axis, n, causal, window, res, do):
    q, k, v, out, lse = res
    B, H, Tq, D = q.shape
    KH = k.shape[1]
    G = H // KH
    Tk = k.shape[2]
    sm_scale = 1.0 / (D ** 0.5)
    idx = jax.lax.axis_index(axis)
    q_off = idx * Tq
    dof = do.astype(jnp.float32)
    # di[b,h,t] = Σ_d out·do — once, locally
    di = jnp.sum(out.astype(jnp.float32) * dof, axis=-1, keepdims=True)
    safe_lse = jnp.where(jnp.isfinite(lse), lse, 0.0)

    def gsum(t):
        # full-head contribution -> shared-KV-head gradient (GQA transpose)
        return (t.reshape(B, KH, G, Tk, D).sum(axis=2) if G > 1 else t)

    h = _ring_hops(n, window, Tk)
    dq = jnp.zeros((B, H, Tq, D), jnp.float32)
    dk0 = jnp.zeros((B, KH, Tk, D), jnp.float32)
    dv0 = jnp.zeros((B, KH, Tk, D), jnp.float32)

    def step(carry, hop):
        k_blk, v_blk, dk_blk, dv_blk, dq = carry
        src = (idx - hop) % n
        kf = jnp.repeat(k_blk, G, axis=1) if G > 1 else k_blk
        vf = jnp.repeat(v_blk, G, axis=1) if G > 1 else v_blk
        s = jnp.einsum("bhqd,bhkd->bhqk", q, kf,
                       preferred_element_type=jnp.float32) * sm_scale
        if causal:
            rows = q_off + jax.lax.broadcasted_iota(jnp.int32, (Tq, Tk), 0)
            cols = src * Tk + jax.lax.broadcasted_iota(jnp.int32, (Tq, Tk), 1)
            keep = cols <= rows
            if window:
                keep &= cols > rows - window
            s = jnp.where(keep, s, -jnp.inf)
        p = jnp.exp(jnp.where(jnp.isfinite(s), s - safe_lse, -jnp.inf))
        dp = jnp.einsum("bhqd,bhkd->bhqk", dof, vf.astype(jnp.float32))
        ds = p * (dp - di) * sm_scale
        dv_blk = dv_blk + gsum(jnp.einsum("bhqk,bhqd->bhkd", p, dof))
        dk_blk = dk_blk + gsum(jnp.einsum("bhqk,bhqd->bhkd", ds,
                                          q.astype(jnp.float32)))
        dq = dq + jnp.einsum("bhqk,bhkd->bhqd", ds,
                             kf.astype(jnp.float32))
        # dk/dv travel WITH the (small) kv block: after the full loop each
        # shard is home again carrying every device's contribution — the
        # backward ring also moves only KH heads under GQA
        perm = _ring_perm(n)
        k_blk = jax.lax.ppermute(k_blk, axis, perm)
        v_blk = jax.lax.ppermute(v_blk, axis, perm)
        dk_blk = jax.lax.ppermute(dk_blk, axis, perm)
        dv_blk = jax.lax.ppermute(dv_blk, axis, perm)
        return (k_blk, v_blk, dk_blk, dv_blk, dq), None

    (k, v, dk, dv, dq), _ = jax.lax.scan(
        step, (k, v, dk0, dv0, dq), jnp.arange(h))
    if h < n:
        # banded ring stopped early: dk/dv sit h steps past home — one
        # direct ppermute returns them (h-1 hops of distance, but a
        # single collective, not n-h rotations)
        home = [(i, (i - h) % n) for i in range(n)]
        dk = jax.lax.ppermute(dk, axis, home)
        dv = jax.lax.ppermute(dv, axis, home)
    return dq.astype(q.dtype), dk.astype(k.dtype), dv.astype(v.dtype)


_ring_local.defvjp(_ring_local_fwd, _ring_local_bwd)


def make_ring_attention(mesh: Mesh, axis: str = "data",
                        causal: bool = False, window: int = 0):
    """Build a jitted (and now differentiable) ring attention: q/k/v
    (B, H, T, D) sharded on T over `axis`; out has the same sharding.
    window > 0 (causal) runs the banded ring — O(window) hops."""
    n = mesh.shape[axis]

    def local_fn(q, k, v):
        return ring_attention_local(q, k, v, axis, n, causal, window)

    spec = P(None, None, axis, None)
    mapped = shard_map(local_fn, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec, check_rep=False)
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# dp × cp GPT training step (VERDICT r2 next-step #3: CP that can TRAIN)
# ---------------------------------------------------------------------------

def make_mesh_dp_cp(dp: int, cp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:dp * cp]
    return Mesh(np.asarray(devices).reshape(dp, cp), ("data", "ctx"))


def _gpt_cp_loss_local(params, tokens, targets, cfg: ViTConfig, n_ctx: int):
    """Per-shard GPT loss: tokens/targets (B_loc, T/n_ctx).  Everything but
    attention is pointwise over T, so the whole block stack runs on the
    local sequence shard; attention goes around the ring.  Loss is the
    global token mean (pmean over both axes happens in the caller)."""
    dtype = jnp.dtype(cfg.dtype)
    idx = jax.lax.axis_index("ctx")
    B, T_loc = tokens.shape
    C, H = cfg.channels, cfg.num_heads
    D = C // H
    # encode with the GLOBAL positions of this shard
    if cfg.pos_emb == "rope":
        x = params["wte"][tokens].astype(dtype)
    else:
        wpe = jax.lax.dynamic_slice(params["wpe"], (idx * T_loc, 0),
                                    (T_loc, params["wpe"].shape[1]))
        x = (params["wte"][tokens] + wpe[None]).astype(dtype)

    def body(x, p):
        ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
        qkv = basic.linear(ln1, p["qkvw"], p["qkvb"])
        # GQA expands K/V to the full head count before the ring (correct
        # but rotates full-width K/V; rotating kv_dim and expanding per ring
        # step is a future traffic lever).  MHA: plain thirds.
        from ..ops.attention import split_gqa
        qp, kp, vp = split_gqa(qkv, H, cfg.kv_heads)
        if cfg.pos_emb == "rope":
            # GLOBAL positions for this sequence shard; keys rotate before
            # the ring, so rotated K blocks circulate correctly
            from ..ops.rope import rope_qk
            qp, kp = rope_qk(qp, kp, idx * T_loc + jnp.arange(T_loc), H,
                             cfg.kv_heads)
        KH = cfg.kv_heads
        q = qp.reshape(B, T_loc, H, D).transpose(0, 2, 1, 3)
        k = kp.reshape(B, T_loc, KH, D).transpose(0, 2, 1, 3)
        v = vp.reshape(B, T_loc, KH, D).transpose(0, 2, 1, 3)
        # GQA: only the KH-head blocks rotate (ring traffic / group size);
        # each step expands its resident block locally (_ring_fwd_scan)
        # cfg.window rides the BANDED ring: O(window) hops — with
        # window <= T/cp that is one neighbor exchange, no full loop
        o = ring_attention_local(q, k, v, "ctx", n_ctx, True,
                                 window=cfg.window)
        atty = o.transpose(0, 2, 1, 3).reshape(B, T_loc, C)
        x = x + basic.linear(atty, p["attprojw"], p["attprojb"])
        ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
        h = basic.gelu_cv(basic.linear(ln2, p["fcw"], p["fcb"]))
        return x + basic.linear(h, p["fcprojw"], p["fcprojb"]), None

    blocks = {kk: params[kk] for kk in M.BLOCK_KEYS}
    x, _ = jax.lax.scan(body, x, blocks,
                        unroll=True if cfg.scan_unroll == 0
                        else cfg.scan_unroll)
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    logits = basic.linear(lnf, params["wte"].astype(lnf.dtype), None)
    return jnp.mean(basic.cross_entropy_from_logits(logits, targets))


def init_cp_opt_state(cfg: ViTConfig, mesh: Mesh):
    """ZeRO-1 m/v: flat f32 sharded over ALL mesh devices (data-major)."""
    n = PRM.num_parameters(cfg)
    size = mesh.size
    n_pad = ((n + size - 1) // size) * size
    sharding = NamedSharding(mesh, P(("data", "ctx")))
    zeros = functools.partial(jnp.zeros, (n_pad,), jnp.float32)
    m = jax.jit(zeros, out_shardings=sharding)()
    v = jax.jit(zeros, out_shardings=sharding)()
    return m, v


def make_cp_train_step(cfg: ViTConfig, mesh: Mesh):
    """dp × cp SPMD training step: params replicated, inputs sharded
    (batch on "data", sequence on "ctx"), nested reduce-scatter ZeRO-1.

    Signature matches the dp step: (params, m, v, inputs, targets, step,
    lr, wd) -> (params, m, v, loss)."""
    dp_n, cp_n = mesh.shape["data"], mesh.shape["ctx"]
    size = dp_n * cp_n
    n = PRM.num_parameters(cfg)
    n_pad = ((n + size - 1) // size) * size
    shard = n_pad // size
    assert cfg.max_seq_len % cp_n == 0

    def spmd_step(params, m_shard, v_shard, inputs, targets, step, lr, wd):
        loss, grads = jax.value_and_grad(_gpt_cp_loss_local)(
            params, inputs, targets, cfg, cp_n)
        flat_g = PRM.flatten_params(grads, cfg)
        if n_pad != n:
            flat_g = jnp.pad(flat_g, (0, n_pad - n))
        # nested reduce-scatter: sum over ctx (1/cp slice), then over data
        # (1/(dp·cp) slice); global offset = data-major over the ctx slice
        g1 = jax.lax.psum_scatter(flat_g, "ctx", scatter_dimension=0,
                                  tiled=True)
        g2 = jax.lax.psum_scatter(g1, "data", scatter_dimension=0,
                                  tiled=True) / size
        i_d = jax.lax.axis_index("data")
        i_c = jax.lax.axis_index("ctx")
        off = i_c * (n_pad // cp_n) + i_d * shard
        flat_p = PRM.flatten_params(params, cfg)
        if n_pad != n:
            flat_p = jnp.pad(flat_p, (0, n_pad - n))
        p_shard = jax.lax.dynamic_slice(flat_p, (off,), (shard,))
        p_shard, m_shard, v_shard = opt.adamw_step(
            p_shard, g2, m_shard, v_shard, step, lr, weight_decay=wd)
        p1 = jax.lax.all_gather(p_shard, "data", tiled=True)
        flat_new = jax.lax.all_gather(p1, "ctx", tiled=True)
        new_params = PRM.unflatten_params(flat_new[:n], cfg)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "ctx"), "data")
        return new_params, m_shard, v_shard, loss

    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(P(), P(("data", "ctx")), P(("data", "ctx")),
                  P("data", "ctx"), P("data", "ctx"), P(), P(), P()),
        out_specs=(P(), P(("data", "ctx")), P(("data", "ctx")), P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1, 2))


def shard_cp_batch(batch, mesh: Mesh):
    """(B, T) host batch -> batch sharded on "data", sequence on "ctx"."""
    return jax.device_put(batch, NamedSharding(mesh, P("data", "ctx")))


# --- Adafactor under CP -----------------------------------------------------
#
# Long-context ring training is exactly the regime where the full fp32 m/v
# pair (2 param-copies, the ZeRO-1 flat shards above) competes with
# activations for HBM.  Adafactor state is ~1e-4 of that, so it simply
# REPLICATES (tree-form, no flat padding): grads are pmean'd over both mesh
# axes in tree form and the plain ops/adafactor.step runs identically on
# every device — no shard_axes (nothing crosses a sharded dim; the ring
# shards the SEQUENCE, not the parameters).

def init_cp_af_state(params, mesh: Mesh):
    from ..ops import adafactor as AF
    repl = NamedSharding(mesh, P())
    state = jax.eval_shape(AF.init_state, params)

    def place(tree):
        return {k: jax.jit(lambda s=v.shape: jnp.zeros(s, jnp.float32),
                           out_shardings=repl)()
                for k, v in tree.items()}

    return AF.AdafactorState(place(state.vr), place(state.vc),
                             place(state.vf), {})


def make_cp_train_step_adafactor(cfg: ViTConfig, mesh: Mesh,
                                 weight_decay_2d_only: bool = True,
                                 relative_step: bool = True):
    """dp x cp training step with replicated Adafactor state.

    Signature: (params, af_state, inputs, targets, step, lr, wd)
            -> (params, af_state, loss)
    """
    from ..ops import adafactor as AF
    from ..ops import optimizer as opt
    from ..params import param_shapes
    cp_n = mesh.shape["ctx"]
    assert cfg.max_seq_len % cp_n == 0

    stspec = AF.state_specs(
        {k: jax.ShapeDtypeStruct(s, jnp.float32)
         for k, s in param_shapes(cfg).items()},
        {k: P() for k in param_shapes(cfg)})
    stspec = AF.AdafactorState({k: P() for k in stspec.vr},
                               {k: P() for k in stspec.vc},
                               {k: P() for k in stspec.vf}, {})

    def spmd_step(params, st, inputs, targets, step, lr, wd):
        loss, grads = jax.value_and_grad(_gpt_cp_loss_local)(
            params, inputs, targets, cfg, cp_n)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(jax.lax.pmean(g, "ctx"), "data"), grads)
        mask = opt.decay_mask_2d(params) if weight_decay_2d_only else None
        params, st = AF.step(params, grads, st, step, lr, weight_decay=wd,
                             decay_mask=mask, relative_step=relative_step)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "ctx"), "data")
        return params, st, loss

    pspec = {k: P() for k in param_shapes(cfg)}
    mapped = shard_map(
        spmd_step, mesh=mesh,
        in_specs=(pspec, stspec, P("data", "ctx"), P("data", "ctx"),
                  P(), P(), P()),
        out_specs=(pspec, stspec, P()),
        check_rep=False)
    return jax.jit(mapped, donate_argnums=(0, 1))
