"""Bit-exact parity mode — the framework's forced-reduction-order path.

Computes the reference model's loss and all 16 parameter gradients with the
EXACT per-lane IEEE-754 f32 operation sequence of the reference's scalar
loops (rusty_vit.rs:484-854, train_vit.rs:559-601), vectorized only over
independent lanes; every reduction runs in the reference's ascending order.
Validated BITWISE (==, not allclose) against the scalar transcription oracle
(oracle/bitexact_ref.py) in tests/test_bitexact.py — the BASELINE.md
'fp32 bit-parity at tiny scale' gate.

MUST RUN EAGERLY (do not wrap in jax.jit): XLA's CPU fusion emitter contracts
mul+add chains into FMAs (measured: `jit(lambda a,b: a*b+a)` differs from
eager by 1 ulp on ~30% of elements, and neither --xla_allow_excess_precision
=false nor lax.optimization_barrier suppresses it).  Eagerly, each op is its
own executable, the mul and add round separately, and every elementwise f32
op is correctly rounded — hence bit-identical to NumPy.  Transcendentals come
from bitmath.py (shared polynomial exp/tanh/cosh) for the same reason.

Tiny-scale tool by design (python loops over reduction dims, eager dispatch);
the production path (models/model.py) keeps XLA fusion and the fused
attention op.  quirks G5/G6/G11/G15 are reproduced as written, like the oracle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..bitmath import exp32, tanh32, cosh32

F = np.float32
GELU_S = F(np.sqrt(np.float32(2.0) / np.float32(np.pi)))
C_GELU = F(0.044715)
EPS = F(1e-5)


def matmul_forward(x, w, b=None):
    """val = bias; val += x[i] * w[o, i], i ascending (rusty_vit.rs:484-498)."""
    B, T, C = x.shape
    OC = w.shape[0]
    acc = (jnp.broadcast_to(b, (B, T, OC)) if b is not None
           else jnp.zeros((B, T, OC), jnp.float32))
    for i in range(C):
        acc = acc + x[:, :, i:i + 1] * w[None, None, :, i]
    return acc


def matmul_backward(dout, x, w, has_bias=True):
    """Two passes in the reference order (rusty_vit.rs:693-720): dinp
    accumulates over o ascending; dweight/dbias over bt ascending."""
    B, T, C = x.shape
    OC = w.shape[0]
    dx = jnp.zeros((B, T, C), jnp.float32)
    for o in range(OC):
        dx = dx + w[None, None, o, :] * dout[:, :, o:o + 1]
    dw = jnp.zeros_like(w)
    db = jnp.zeros((OC,), jnp.float32) if has_bias else None
    xf = x.reshape(B * T, C)
    df = dout.reshape(B * T, OC)
    for bt in range(B * T):
        if has_bias:
            db = db + df[bt]
        dw = dw + xf[bt][None, :] * df[bt][:, None]
    return dx, dw, db


def layernorm_forward(x, w, b):
    """Ascending mean/var accumulation, /C division (rusty_vit.rs:578-605)."""
    B, T, C = x.shape
    cf = F(C)
    m = jnp.zeros((B, T), jnp.float32)
    for i in range(C):
        m = m + x[:, :, i]
    m = m / cf
    v = jnp.zeros((B, T), jnp.float32)
    for i in range(C):
        xs = x[:, :, i] - m
        v = v + xs * xs
    v = v / cf
    s = F(1.0) / jnp.sqrt(v + EPS)
    n = s[..., None] * (x - m[..., None])
    return n * w + b, m, s


def layernorm_backward(dout, x, w, mean, rstd, dx_acc=None):
    """rusty_vit.rs:737-783: two ascending reduce loops, then the elementwise
    dval sequence (+=dnorm; -=dnorm_mean; -=norm*dnnm; *=rstd)."""
    B, T, C = x.shape
    cf = F(C)
    m = mean[..., None]
    s = rstd[..., None]
    dnm = jnp.zeros((B, T), jnp.float32)
    dnnm = jnp.zeros((B, T), jnp.float32)
    for i in range(C):
        norm_i = (x[:, :, i] - mean) * rstd
        dn_i = w[i] * dout[:, :, i]
        dnm = dnm + dn_i
        dnnm = dnnm + dn_i * norm_i
    dnm = dnm / cf
    dnnm = dnnm / cf
    norm = (x - m) * s
    dn = w * dout
    dval = ((dn - dnm[..., None]) - norm * dnnm[..., None]) * s
    dx = dval if dx_acc is None else dx_acc + dval
    dw = jnp.zeros((C,), jnp.float32)
    db = jnp.zeros((C,), jnp.float32)
    nf = norm.reshape(B * T, C)
    df = dout.reshape(B * T, C)
    for bt in range(B * T):
        db = db + df[bt]
        dw = dw + nf[bt] * df[bt]
    return dx, dw, db


def _split_heads(qkv, num_heads):
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    x = qkv.reshape(B, T, 3, num_heads, HS)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2], C, HS   # (B,T,NH,HS) each


def attention_forward(qkv, num_heads):
    """Scalar online-softmax order per (b,t,h) lane: -10000 max init (G11),
    exp-sum ascending, normalization excluding t2==t (G5), V-accum t2
    ascending (rusty_vit.rs:512-563).  Returns (out, att) with att as a
    nested python list att[t][t2] of (B,NH) lane arrays."""
    q, k, v, C, HS = _split_heads(qkv, num_heads)
    B, T = q.shape[0], q.shape[1]
    scale = F(1.0) / np.sqrt(F(HS))
    att: list = []
    outs = []
    for t in range(T):
        pre = []
        maxval = jnp.full((B, q.shape[2]), F(-10000.0))
        for t2 in range(t + 1):
            val = jnp.zeros((B, q.shape[2]), jnp.float32)
            for i in range(HS):
                val = val + q[:, t, :, i] * k[:, t2, :, i]
            val = val * scale
            maxval = jnp.where(val > maxval, val, maxval)
            pre.append(val)
        expsum = jnp.zeros_like(maxval)
        e = []
        for t2 in range(t + 1):
            ev = exp32(pre[t2] - maxval, jnp)
            expsum = expsum + ev
            e.append(ev)
        inv = jnp.where(expsum == F(0.0), F(0.0), F(1.0) / expsum)
        row = [e[t2] * inv for t2 in range(t)] + [e[t]]     # G5: t2==t raw
        att.append(row)
        out_t = jnp.zeros((B, q.shape[2], HS), jnp.float32)
        for t2 in range(t + 1):
            out_t = out_t + row[t2][..., None] * v[:, t2]
        outs.append(out_t)
    out = jnp.stack(outs, axis=1).reshape(B, T, C)
    return out, att


def attention_backward(dout, qkv, att, num_heads):
    """train_vit.rs:559-601 loop nests: datt over i ascending, dv/dk over
    queries t ascending, dpreatt over t2 ascending, (x*dpre)*scale."""
    q, k, v, C, HS = _split_heads(qkv, num_heads)
    B, T = q.shape[0], q.shape[1]
    NH = q.shape[2]
    scale = F(1.0) / np.sqrt(F(HS))
    do = dout.reshape(B, T, NH, HS)
    zl = lambda: jnp.zeros((B, NH, HS), jnp.float32)
    dv_l = [zl() for _ in range(T)]
    dk_l = [zl() for _ in range(T)]
    dq_l = [zl() for _ in range(T)]
    for t in range(T):
        datt = []
        for t2 in range(t + 1):
            acc = jnp.zeros((B, NH), jnp.float32)
            for i in range(HS):
                acc = acc + v[:, t2, :, i] * do[:, t, :, i]
            datt.append(acc)
            dv_l[t2] = dv_l[t2] + att[t][t2][..., None] * do[:, t]
        att_row = jnp.stack(att[t], axis=-1)               # (B,NH,t+1)
        eye = np.eye(t + 1, dtype=np.float32)
        dpre = jnp.zeros((B, NH, t + 1), jnp.float32)
        for t2 in range(t + 1):
            local = att[t][t2][..., None] * (eye[t2] - att_row)
            dpre = dpre + local * datt[t2][..., None]
        for t2 in range(t + 1):
            dq_l[t] = dq_l[t] + (k[:, t2] * dpre[:, :, t2:t2 + 1]) * scale
            dk_l[t2] = dk_l[t2] + (q[:, t] * dpre[:, :, t2:t2 + 1]) * scale
    B_, NH_ = B, NH
    dq = jnp.stack(dq_l, axis=1).reshape(B_, T, C)
    dk = jnp.stack(dk_l, axis=1).reshape(B_, T, C)
    dv = jnp.stack(dv_l, axis=1).reshape(B_, T, C)
    return jnp.concatenate([dq, dk, dv], axis=-1)


def gelu_forward(x):
    cube = C_GELU * x * x * x
    return F(0.5) * x * (F(1.0) + tanh32(GELU_S * (x + cube), jnp))


def gelu_backward(dout, x):
    """G15 as written: sech^2(2a) via cosh(2a) (rusty_vit.rs:800-802)."""
    cube = C_GELU * x * x * x
    a = GELU_S * (x + cube)
    th = tanh32(a, jnp)
    ch = cosh32(F(2.0) * a, jnp)
    sech = F(1.0) / (ch * ch)
    local = (F(0.5) * (F(1.0) + th)
             + x * F(0.5) * sech * GELU_S
             * (F(1.0) + F(3.0) * C_GELU * x * x))
    return local * dout


def softmax_forward(logits):
    """G11 max init; ascending exp-sum; element-by-sum DIVISION."""
    B, T, V = logits.shape
    maxval = jnp.full((B, T), F(-10000.0))
    for i in range(V):
        maxval = jnp.where(logits[:, :, i] > maxval, logits[:, :, i], maxval)
    s = jnp.zeros((B, T), jnp.float32)
    e = []
    for i in range(V):
        ev = exp32(logits[:, :, i] - maxval, jnp)
        s = s + ev
        e.append(ev)
    return jnp.stack([ev / s for ev in e], axis=-1)


def model_forward(params: Dict, inputs, targets: Optional[np.ndarray],
                  num_heads: int) -> Tuple[jnp.ndarray, dict]:
    """Forward in the reference's exact op order (rusty_vit.rs:269-351).
    Loss mean accumulates flat-ascending then divides, like :342-347."""
    p = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    inputs = np.asarray(inputs)
    B, T = inputs.shape
    L = p["ln1w"].shape[0]
    acts: dict = {k: [] for k in
                  ("ln1", "ln1_mean", "ln1_rstd", "qkv", "atty", "att",
                   "attproj", "residual2", "ln2", "ln2_mean", "ln2_rstd",
                   "fch", "fch_gelu", "fcproj", "residual3")}
    x = p["wte"][inputs] + p["wpe"][None, :T, :]
    acts["encoded"] = x
    residual = x
    for l in range(L):
        ln1, m1, r1 = layernorm_forward(residual, p["ln1w"][l], p["ln1b"][l])
        qkv = matmul_forward(ln1, p["qkvw"][l], p["qkvb"][l])
        atty, att = attention_forward(qkv, num_heads)
        attproj = matmul_forward(atty, p["attprojw"][l], p["attprojb"][l])
        residual2 = residual + attproj
        ln2, m2, r2 = layernorm_forward(residual2, p["ln2w"][l], p["ln2b"][l])
        fch = matmul_forward(ln2, p["fcw"][l], p["fcb"][l])
        fch_gelu = gelu_forward(fch)
        fcproj = matmul_forward(fch_gelu, p["fcprojw"][l], p["fcprojb"][l])
        residual3 = residual2 + fcproj
        for k_, v_ in (("ln1", ln1), ("ln1_mean", m1), ("ln1_rstd", r1),
                       ("qkv", qkv), ("atty", atty), ("att", att),
                       ("attproj", attproj), ("residual2", residual2),
                       ("ln2", ln2), ("ln2_mean", m2), ("ln2_rstd", r2),
                       ("fch", fch), ("fch_gelu", fch_gelu),
                       ("fcproj", fcproj), ("residual3", residual3)):
            acts[k_].append(v_)
        residual = residual3
    lnf, mf, rf = layernorm_forward(residual, p["lnfw"], p["lnfb"])
    logits = matmul_forward(lnf, p["wte"], None)
    probs = softmax_forward(logits)
    acts.update(lnf=lnf, lnf_mean=mf, lnf_rstd=rf, logits=logits, probs=probs,
                params=p)
    if targets is None:
        return jnp.asarray(F(-1.0)), acts
    targets = np.asarray(targets)
    losses = []
    for bi in range(B):
        for t in range(T):
            losses.append(-probs[bi, t, targets[bi, t]])
    mean_loss = jnp.asarray(F(0.0))
    for lv in losses:
        mean_loss = mean_loss + lv
    mean_loss = mean_loss / F(B * T)
    return mean_loss, acts


def model_backward(acts: dict, inputs, targets, num_heads: int) -> Dict:
    """Hand-sequenced reverse in the reference's order (rusty_vit.rs:354-449),
    including the += order into the shared dresidual stream."""
    p = acts["params"]
    inputs = np.asarray(inputs)
    targets = np.asarray(targets)
    B, T = inputs.shape
    V, C = p["wte"].shape
    L = p["ln1w"].shape[0]
    g = {k: jnp.zeros_like(v) for k, v in p.items()}

    dloss = F(1.0) / F(B * T)
    onehot = np.zeros((B, T, V), np.float32)
    for bi in range(B):
        for t in range(T):
            onehot[bi, t, targets[bi, t]] = 1.0
    dlogits = (acts["probs"] - onehot) * dloss
    dlnf, dwte_head, _ = matmul_backward(dlogits, acts["lnf"], p["wte"],
                                         has_bias=False)
    g["wte"] = g["wte"] + dwte_head
    dresidual3, dlnfw, dlnfb = layernorm_backward(
        dlnf, acts["residual3"][L - 1], p["lnfw"], acts["lnf_mean"],
        acts["lnf_rstd"])
    g["lnfw"] = g["lnfw"] + dlnfw
    g["lnfb"] = g["lnfb"] + dlnfb
    for l in reversed(range(L)):
        res_in = acts["encoded"] if l == 0 else acts["residual3"][l - 1]
        dfcproj = dresidual3
        dfch_gelu, dpw, dpb = matmul_backward(dfcproj, acts["fch_gelu"][l],
                                              p["fcprojw"][l])
        g["fcprojw"] = g["fcprojw"].at[l].add(dpw)
        g["fcprojb"] = g["fcprojb"].at[l].add(dpb)
        dfch = gelu_backward(dfch_gelu, acts["fch"][l])
        dln2, dfw, dfb = matmul_backward(dfch, acts["ln2"][l], p["fcw"][l])
        g["fcw"] = g["fcw"].at[l].add(dfw)
        g["fcb"] = g["fcb"].at[l].add(dfb)
        dresidual2, dw2, db2 = layernorm_backward(
            dln2, acts["residual2"][l], p["ln2w"][l], acts["ln2_mean"][l],
            acts["ln2_rstd"][l], dx_acc=dresidual3)
        g["ln2w"] = g["ln2w"].at[l].add(dw2)
        g["ln2b"] = g["ln2b"].at[l].add(db2)
        dattproj = dresidual2
        datty, daw, dab = matmul_backward(dattproj, acts["atty"][l],
                                          p["attprojw"][l])
        g["attprojw"] = g["attprojw"].at[l].add(daw)
        g["attprojb"] = g["attprojb"].at[l].add(dab)
        dqkv = attention_backward(datty, acts["qkv"][l], acts["att"][l],
                                  num_heads)
        dln1, dqw, dqb = matmul_backward(dqkv, acts["ln1"][l], p["qkvw"][l])
        g["qkvw"] = g["qkvw"].at[l].add(dqw)
        g["qkvb"] = g["qkvb"].at[l].add(dqb)
        dresidual3, dw1, db1 = layernorm_backward(
            dln1, res_in, p["ln1w"][l], acts["ln1_mean"][l],
            acts["ln1_rstd"][l], dx_acc=dresidual2)
        g["ln1w"] = g["ln1w"].at[l].add(dw1)
        g["ln1b"] = g["ln1b"].at[l].add(db1)
    # encoder_backward (G2): (b, t) ascending scatter
    for bi in range(B):
        for t in range(T):
            g["wte"] = g["wte"].at[inputs[bi, t]].add(dresidual3[bi, t])
            g["wpe"] = g["wpe"].at[t].add(dresidual3[bi, t])
    return g


def loss_and_grads(params: Dict, inputs, targets, num_heads: int):
    """(loss, grads) through the forced-order path.  Eager by contract."""
    loss, acts = model_forward(params, inputs, targets, num_heads)
    return loss, model_backward(acts, inputs, targets, num_heads)
