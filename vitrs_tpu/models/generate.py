"""Autoregressive generation with a KV cache (GPT mode).

The reference has no sampling/generation loop (SURVEY.md §3.5: 'No
sampling/generation loop exists in-repo'); its inference story is 'forward
without targets'.  This module supplies the serving path: a prefill pass that
populates per-layer K/V caches in one batched sweep, then a jit-compiled
`lax.scan` decode loop touching only one token per step — O(T) per token
instead of the O(T²) full recompute.

Cache layout: (L, B, Tmax, kv_dim) for K and V — the packed convention of
the qkv activations (KV head g at channels [g·D,(g+1)·D)), so decode
attention reads it with the same head slicing as the reference layout.
kv_dim == C for MHA; under GQA/MQA (config.num_kv_heads) the cache holds
only kv_heads·D channels per token — the cache memory and decode HBM
traffic shrink by num_heads/kv_heads, which is the point of GQA serving.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from ..config import ViTConfig
from ..ops import basic
from ..ops.rope import rope_qk
from . import model as M


def quantize_kv(x: jax.Array, num_heads: int):
    """(B, S, C) -> (int8 (B, S, NH, D), per-(token, head) absmax scale).

    Symmetric per-token-per-head quantization: decode attention is
    HBM-bound on the cache reads, so int8 halves (vs bf16) the bytes per
    generated token; the absmax granularity keeps head-scale outliers from
    washing out other heads."""
    B, S, C = x.shape
    xh = x.reshape(B, S, num_heads, C // num_heads).astype(jnp.float32)
    scale = jnp.max(jnp.abs(xh), axis=-1, keepdims=True)
    scale = jnp.maximum(scale, 1e-8)
    q = jnp.clip(jnp.round(xh / scale * 127.0), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def _dequant(q: jax.Array, scale: jax.Array, dtype) -> jax.Array:
    # (B, T, NH, D) int8 * (B, T, NH, 1) -> (B, NH, T, D)
    x = q.astype(jnp.float32) * (scale * (1.0 / 127.0))
    return x.transpose(0, 2, 1, 3).astype(dtype)


def _split_qkv(qkv: jax.Array, cfg: ViTConfig):
    """(B, S, C + 2*kv_dim) -> q (B,S,C), k/v (B,S,kv_dim) — the cfg-driven
    wrapper of ops/attention.split_gqa (one slicing convention)."""
    from ..ops.attention import split_gqa
    return split_gqa(qkv, cfg.num_heads, cfg.kv_heads)


def _cache_attention(qh: jax.Array, kh: jax.Array, vh: jax.Array,
                     mask_bst: jax.Array, out_dtype) -> jax.Array:
    """Grouped cache attention: qh (B, NH, S, D) against kh/vh
    (B, KH, T, D) with KH | NH; mask broadcastable to (B, S, T).

    The query heads are folded to (B, KH, G, S, D) so each KV head is read
    ONCE from HBM and contracted against its whole group on-chip — under
    GQA the decode cache traffic stays proportional to KH, never
    materializing a repeated (B, NH, T, D) buffer.  KH == NH (G=1) reduces
    to standard MHA decode."""
    B, NH, S, D = qh.shape
    KH = kh.shape[1]
    G = NH // KH
    qg = qh.reshape(B, KH, G, S, D)
    scale = 1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32))
    s = jnp.einsum("bkgsd,bktd->bkgst", qg, kh,
                   preferred_element_type=jnp.float32) * scale
    s = jnp.where(mask_bst[:, None, None], s, -jnp.inf)
    att = jax.nn.softmax(s, axis=-1).astype(vh.dtype)
    out = jnp.einsum("bkgst,bktd->bkgsd", att, vh,
                     preferred_element_type=jnp.float32)
    return out.reshape(B, NH, S, D).astype(out_dtype)


def _plin(p: Dict, wkey: str, bkey, x: jax.Array) -> jax.Array:
    """Linear that transparently takes int8 weight-only quantized params
    (ops/quant.py layout: `wkey` int8 + `wkey + '_scale'` per-OC f32).
    Weight-only int8 halves the per-token weight reads — generation is
    weight-bound (BASELINE.md: 248 MB/step of weights at GPT-2 B=8)."""
    b = p[bkey] if bkey is not None else None
    if wkey + "_scale" in p:
        from ..ops import quant
        return quant.linear_w8(x, p[wkey], p[wkey + "_scale"], b)
    return basic.linear(x, p[wkey], b)


def _block_keys(params: Dict, cfg: ViTConfig) -> tuple:
    """Per-layer stacked leaves consumed by the decode scans: the standard
    block keys, + routerw under MoE, + any int8 '_scale' companions."""
    keys = M.BLOCK_KEYS + (("routerw",) if cfg.is_moe else ())
    return keys + tuple(k + "_scale" for k in M.BLOCK_KEYS
                        if k + "_scale" in params)


def _mlp(p: Dict, cfg: ViTConfig, ln2: jax.Array) -> jax.Array:
    """The block's MLP half for every decode path: dense fc/gelu/fcproj
    (int8-weight aware via _plin) or the MoE layer (config.num_experts —
    router aux losses are dropped at inference; expert weights stay at
    full precision: weight-only int8 quantization of the expert slabs is
    not wired)."""
    if cfg.is_moe:
        from ..ops.moe import moe_mlp
        out, _ = moe_mlp(ln2, p["routerw"], p["fcw"], p["fcb"],
                         p["fcprojw"], p["fcprojb"], top_k=cfg.moe_top_k,
                         cap_factor=cfg.moe_cap_factor,
                         erf=cfg.act == "gelu_erf")
        return out
    h = _plin(p, "fcw", "fcb", ln2)
    hg = basic.gelu_erf_cv(h) if cfg.act == "gelu_erf" else basic.gelu_cv(h)
    return _plin(p, "fcprojw", "fcprojb", hg)


def _block_with_kv(x, p, cfg, k_cache, v_cache, pos):
    """One block step that reads/updates its (B, Tmax, C) cache slice.

    x: (B, S, C) — S = prompt length at prefill, 1 at decode.
    pos: starting position of x within the sequence (scalar).
    Math is the standard block (rusty_vit.rs:322-331) with attention masked
    to positions <= query position.

    Caches are either raw arrays (B, Tmax, C) or int8 tuples
    ((B, Tmax, NH, D) int8, (B, Tmax, NH, 1) f32 scale).
    """
    B, S, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    D = C // NH
    int8_cache = isinstance(k_cache, tuple)
    Tmax = k_cache[0].shape[1] if int8_cache else k_cache.shape[1]
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = _plin(p, "qkvw", "qkvb", ln1)
    q, k, v = _split_qkv(qkv, cfg)              # (B,S,C) / (B,S,kv_dim) x2
    if cfg.pos_emb == "rope":
        # rotate with absolute positions; the cache stores rotated K, so
        # decode attention needs no re-rotation of history
        q, k = rope_qk(q, k, pos + jnp.arange(S), cfg.num_heads,
                       cfg.kv_heads)
    if int8_cache:
        kq, ks = quantize_kv(k, KH)
        vq, vs = quantize_kv(v, KH)
        k_cache = (jax.lax.dynamic_update_slice(k_cache[0], kq, (0, pos, 0, 0)),
                   jax.lax.dynamic_update_slice(k_cache[1], ks, (0, pos, 0, 0)))
        v_cache = (jax.lax.dynamic_update_slice(v_cache[0], vq, (0, pos, 0, 0)),
                   jax.lax.dynamic_update_slice(v_cache[1], vs, (0, pos, 0, 0)))
        kh = _dequant(*k_cache, x.dtype)
        vh = _dequant(*v_cache, x.dtype)
    else:
        k_cache = jax.lax.dynamic_update_slice(k_cache, k, (0, pos, 0))
        v_cache = jax.lax.dynamic_update_slice(v_cache, v, (0, pos, 0))
        kh = k_cache.reshape(B, Tmax, KH, D).transpose(0, 2, 1, 3)
        vh = v_cache.reshape(B, Tmax, KH, D).transpose(0, 2, 1, 3)

    # attention of q against the cache, causal w.r.t. absolute positions.
    # Fresh-prompt prefill (static pos == 0, S > 1) is plain causal
    # SELF-attention over the prompt — route it through the attention op
    # (ops/attention.py) instead of the dense cache form, whose (S, Tmax)
    # score tensor is O(S·Tmax) memory.  Cache slots ≥ S hold nothing the
    # causal mask would admit, so the math is identical.  int8 caches take
    # this path too: the prefill attends with the EXACT k/v (the stored
    # history stays quantized for decode), within the mode's tolerance
    # contract (tests/test_serving_depth.py).  Continuation chunks
    # (pos > 0) and decode use the dense cache form.
    if isinstance(pos, int) and pos == 0 and S > 1 and not cfg.quirks:
        from ..ops.attention import attention
        atty = attention(jnp.concatenate([q, k, v], axis=-1), NH,
                         causal=True, use_flash=cfg.use_flash,
                         window=cfg.window, kv_heads=KH)
    else:
        qh = q.reshape(B, S, NH, D).transpose(0, 2, 1, 3)   # (B, NH, S, D)
        q_pos = pos + jnp.arange(S)[:, None]                # (S, 1)
        t_pos = jnp.arange(Tmax)[None, :]                   # (1, Tmax)
        mask = t_pos <= q_pos                               # causal+unfilled
        if cfg.window:
            mask = jnp.logical_and(mask, t_pos > q_pos - cfg.window)
        atty = _cache_attention(qh, kh, vh, mask[None], x.dtype)
        atty = atty.transpose(0, 2, 1, 3).reshape(B, S, C)

    x = x + _plin(p, "attprojw", "attprojb", atty)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    x = x + _mlp(p, cfg, ln2)
    return x, k_cache, v_cache


def init_kv_cache(cfg: ViTConfig, B: int, Tmax: int, int8: bool = False):
    if int8:
        KH, D = cfg.kv_heads, cfg.head_size
        q = (cfg.num_layers, B, Tmax, KH, D)
        s = (cfg.num_layers, B, Tmax, KH, 1)
        return ((jnp.zeros(q, jnp.int8), jnp.ones(s, jnp.float32)),
                (jnp.zeros(q, jnp.int8), jnp.ones(s, jnp.float32)))
    dtype = jnp.dtype(cfg.dtype)
    shape = (cfg.num_layers, B, Tmax, cfg.kv_dim)
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


def forward_with_cache(params: Dict, tokens: jax.Array, caches, pos,
                       cfg: ViTConfig, last_only: bool = False):
    """Run S tokens starting at `pos` through the stack, updating caches.
    Returns (logits (B, S, V), caches) — or (B, 1, V) when last_only
    (prefill only needs the final position's logits to seed sampling;
    the full (B, S, V) head output is 6.4 GB at B=8, S≈8K, V=50304)."""
    k_caches, v_caches = caches
    dtype = jnp.dtype(cfg.dtype)
    S = tokens.shape[-1]
    int8_w = "wte_scale" in params          # weight-only quantized params
    emb = params["wte"][tokens].astype(dtype)
    if int8_w:
        emb = emb * params["wte_scale"][tokens][..., None].astype(dtype)
    if cfg.pos_emb == "rope":
        x = emb
    else:
        x = emb + jax.lax.dynamic_slice_in_dim(
            params["wpe"], pos, S, 0)[None].astype(dtype)
    blocks = {k: params[k] for k in _block_keys(params, cfg)}

    def step(x, layer):
        p, kc, vc = layer
        x, kc, vc = _block_with_kv(x, p, cfg, kc, vc, pos)
        return x, (kc, vc)

    x, (k_caches, v_caches) = jax.lax.scan(step, x,
                                           (blocks, k_caches, v_caches))
    if last_only:
        x = x[:, -1:, :]
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    if int8_w:
        from ..ops import quant
        logits = quant.linear_w8(lnf, params["wte"], params["wte_scale"])
    else:
        logits = basic.linear(lnf, params["wte"].astype(dtype), None)
    return logits.astype(jnp.float32), (k_caches, v_caches)


def _filter_logits(logits, top_k: int, top_p: float):
    """Static top-k and/or nucleus (top-p) filtering, XLA-shape-static:
    top-p keeps the smallest set of tokens whose probability mass reaches p
    (the argmax always survives).  Shared by generate() and the chunked
    engine ticks."""
    if top_k:
        kth = jnp.sort(logits, axis=-1)[..., -top_k][..., None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p and top_p < 1.0:
        srt = jnp.sort(logits, axis=-1)[..., ::-1]          # descending
        probs = jax.nn.softmax(srt, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        keep = (cum - probs) < top_p          # exclusive-prefix < p
        kth = jnp.min(jnp.where(keep, srt, jnp.inf), axis=-1, keepdims=True)
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    return logits


def _sample(logits, key, temperature, top_k, top_p=0.0):
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1)
    logits = _filter_logits(logits / temperature, top_k, top_p)
    return jax.random.categorical(key, logits, axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg", "max_new", "temperature",
                                             "top_k", "top_p", "kv_int8",
                                             "prefill_chunk"))
def generate(params: Dict, prompt: jax.Array, cfg: ViTConfig, max_new: int,
             key: jax.Array, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 0.0,
             kv_int8: bool = False, prefill_chunk: int = 0) -> jax.Array:
    """prompt (B, T0) -> (B, T0 + max_new).  Prefill once, then scan decode.
    kv_int8=True stores the KV cache quantized (per-token-per-head absmax
    int8) — half the decode HBM traffic vs bf16 at ~1e-2 logit error.

    prefill_chunk > 0 runs the prefill in fixed-size segments through the
    same cache API: a whole-prompt prefill materializes (B, T0, V) logits —
    6.4 GB at B=8, T0≈8K, V=50304 — while chunks keep it at
    (B, chunk, V).  prefill_chunk must divide T0; the last chunk's logits seed
    the first sampled token, so the math is identical."""
    B, T0 = prompt.shape
    Tmax = T0 + max_new
    assert Tmax <= cfg.max_seq_len
    caches = init_kv_cache(cfg, B, Tmax, int8=kv_int8)
    key, first_key = jax.random.split(key)
    if prefill_chunk and T0 > prefill_chunk:
        assert T0 % prefill_chunk == 0, (T0, prefill_chunk)
        for off in range(0, T0, prefill_chunk):
            logits, caches = forward_with_cache(
                params, prompt[:, off:off + prefill_chunk], caches, off, cfg,
                last_only=True)
    else:
        # last_only: sampling needs only the final position's logits, so
        # the (B, T0, V) head output never materializes
        logits, caches = forward_with_cache(params, prompt, caches, 0, cfg,
                                            last_only=True)
    first = _sample(logits[:, -1, :], first_key, temperature, top_k, top_p)
    if max_new == 1:
        return jnp.concatenate([prompt, first[:, None]], axis=1)

    def decode(carry, step_key):
        tok, pos, caches = carry
        lg, caches = forward_with_cache(params, tok[:, None], caches, pos, cfg)
        nxt = _sample(lg[:, -1, :], step_key, temperature, top_k, top_p)
        return (nxt, pos + 1, caches), tok

    keys = jax.random.split(key, max_new - 1)
    (last, _, _), toks = jax.lax.scan(decode, (first, T0, caches), keys)
    gen = jnp.concatenate([toks.T, last[:, None]], axis=1)   # (B, max_new)
    return jnp.concatenate([prompt, gen], axis=1)


# --------------------------------------------------------------------------
# Beam search: XLA-static beam decode over the same KV-cache machinery.
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "max_new", "beams"))
def generate_beam(params: Dict, prompt: jax.Array, cfg: ViTConfig,
                  max_new: int, beams: int = 4) -> jax.Array:
    """Beam-search decode: prompt (B, T0) -> (B, T0 + max_new), the highest
    cumulative-log-prob beam per example.  Everything is shape-static: the
    beam axis is folded into the batch of the cache (B*beams rows), each
    step takes top-`beams` over the (beams*V) continuations and gathers the
    winning beams' caches by parent index (the standard beam recurrence).

    All beams run exactly max_new steps (no EOS retirement — the serving
    engine owns retirement), so every candidate has equal length and a
    length penalty would not change the ranking; the score is the plain
    cumulative log-prob.  beams=1 reduces to greedy decode.
    """
    B, T0 = prompt.shape
    Tmax = T0 + max_new
    assert Tmax <= cfg.max_seq_len or cfg.pos_emb == "rope"
    V = cfg.vocab_size

    # prefill once at beam width 1, then tile the caches to B*beams
    caches = init_kv_cache(cfg, B, Tmax)
    logits, caches = forward_with_cache(params, prompt, caches, 0, cfg)
    logp0 = jax.nn.log_softmax(logits[:, -1].astype(jnp.float32))   # (B, V)
    top0, tok0 = jax.lax.top_k(logp0, beams)                 # (B, beams)

    def tile(c):
        # (L, B, T, ·) -> (L, B*beams, T, ·): beam-major rows per example
        return jnp.repeat(c, beams, axis=1)

    caches = jax.tree_util.tree_map(tile, caches)
    cum = top0.reshape(B * beams)                            # (B*beams,)
    tok = tok0.reshape(B * beams)
    # generated tokens ring; row b*beams+j is example b's beam j
    gen0 = jnp.zeros((B * beams, max_new), jnp.int32)
    gen0 = gen0.at[:, 0].set(tok)

    def step(carry, pos):
        cum, tok, gen, caches = carry
        lg, caches = forward_with_cache(params, tok[:, None], caches, pos,
                                        cfg)
        logp = jax.nn.log_softmax(lg[:, 0].astype(jnp.float32))  # (B*bm, V)
        cand = cum[:, None] + logp                           # (B*bm, V)
        cand = cand.reshape(B, beams * V)
        cum_new, flat = jax.lax.top_k(cand, beams)           # (B, beams)
        parent = flat // V                                   # beam index
        tok_new = flat % V
        # gather winning parents' caches and histories
        rows = (jnp.arange(B)[:, None] * beams + parent).reshape(-1)
        caches = jax.tree_util.tree_map(lambda c: c[:, rows], caches)
        gen = gen[rows]
        gen = gen.at[:, pos - T0 + 1].set(tok_new.reshape(-1))
        return (cum_new.reshape(-1), tok_new.reshape(-1).astype(jnp.int32),
                gen, caches), None

    if max_new > 1:
        (cum, tok, gen, caches), _ = jax.lax.scan(
            step, (cum, tok.astype(jnp.int32), gen0, caches),
            jnp.arange(T0, T0 + max_new - 1))
    else:
        gen = gen0
    best = jnp.argmax(cum.reshape(B, beams), axis=-1)       # (B,)
    gen = gen.reshape(B, beams, max_new)[jnp.arange(B), best]
    return jnp.concatenate([prompt, gen], axis=1)


# --------------------------------------------------------------------------
# Streaming decode: ring-buffer KV cache for sliding-window models.
#
# A window-W model (config.window) never attends more than W positions back,
# so the cache only has to hold a rolling band: a ring of R = W + chunk rows
# per layer, written at row (pos % R).  Each row's ABSOLUTE position is
# reconstructed arithmetically (stored[j] = latest p <= pos_end with
# p ≡ j mod R), so masking needs no per-row bookkeeping state and the whole
# decode stays XLA-static.  With rope positions (config.pos_emb="rope")
# generation length is unbounded — O(L·B·R·kv_dim) memory for ANY length,
# where the dense cache would grow O(T) and the reference's wpe table would
# cap T outright (rusty_vit.rs:107).
# --------------------------------------------------------------------------

def init_ring_kv(cfg: ViTConfig, B: int, chunk: int):
    """Ring caches sized W + chunk: a chunk of S <= chunk new positions can
    be written without evicting any key still inside some query's window."""
    assert cfg.window > 0, "ring cache requires a sliding-window config"
    R = cfg.window + chunk
    dtype = jnp.dtype(cfg.dtype)
    shape = (cfg.num_layers, B, R, cfg.kv_dim)
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


def _block_with_kv_ring(x, p, cfg, k_cache, v_cache, pos):
    """One block step against ring caches (B, R, kv_dim); pos scalar."""
    B, S, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    D = C // NH
    R = k_cache.shape[1]
    W = cfg.window
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = _plin(p, "qkvw", "qkvb", ln1)
    q, k, v = _split_qkv(qkv, cfg)
    if cfg.pos_emb == "rope":
        q, k = rope_qk(q, k, pos + jnp.arange(S), cfg.num_heads,
                       cfg.kv_heads)
    rows = (pos + jnp.arange(S)) % R
    k_cache = k_cache.at[:, rows].set(k)
    v_cache = v_cache.at[:, rows].set(v)
    kh = k_cache.reshape(B, R, KH, D).transpose(0, 2, 1, 3)
    vh = v_cache.reshape(B, R, KH, D).transpose(0, 2, 1, 3)
    qh = q.reshape(B, S, NH, D).transpose(0, 2, 1, 3)
    # absolute position held by ring row j right now (after this write):
    # the latest p <= pos_end with p ≡ j (mod R); negative = never written
    pos_end = pos + S - 1
    j = jnp.arange(R)
    stored = pos_end - ((pos_end - j) % R)                  # (R,)
    q_pos = pos + jnp.arange(S)[:, None]                    # (S, 1)
    mask = jnp.logical_and(stored[None, :] <= q_pos,
                           stored[None, :] > q_pos - W)
    mask = jnp.logical_and(mask, stored[None, :] >= 0)
    atty = _cache_attention(qh, kh, vh, mask[None], x.dtype)
    atty = atty.transpose(0, 2, 1, 3).reshape(B, S, C)
    x = x + _plin(p, "attprojw", "attprojb", atty)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    x = x + _mlp(p, cfg, ln2)
    return x, k_cache, v_cache


def forward_with_ring(params: Dict, tokens: jax.Array, caches, pos,
                      cfg: ViTConfig):
    """Ring twin of forward_with_cache; S must be <= the chunk the ring was
    sized for.  Returns (logits (B, S, V), caches)."""
    k_caches, v_caches = caches
    dtype = jnp.dtype(cfg.dtype)
    S = tokens.shape[-1]
    emb = params["wte"][tokens].astype(dtype)
    if cfg.pos_emb == "rope":
        x = emb
    else:
        x = emb + jax.lax.dynamic_slice_in_dim(
            params["wpe"], pos, S, 0)[None].astype(dtype)
    blocks = {k: params[k] for k in _block_keys(params, cfg)}

    def step(x, layer):
        p, kc, vc = layer
        x, kc, vc = _block_with_kv_ring(x, p, cfg, kc, vc, pos)
        return x, (kc, vc)

    x, (k_caches, v_caches) = jax.lax.scan(step, x,
                                           (blocks, k_caches, v_caches))
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    logits = basic.linear(lnf, params["wte"].astype(dtype), None)
    return logits.astype(jnp.float32), (k_caches, v_caches)


@functools.partial(jax.jit, static_argnames=("cfg", "max_new", "temperature",
                                             "top_k", "top_p"))
def generate_streaming(params: Dict, prompt: jax.Array, cfg: ViTConfig,
                       max_new: int, key: jax.Array,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0) -> jax.Array:
    """Windowed generation with O(window) cache memory, independent of the
    total length.  With cfg.pos_emb="rope" the output length is unbounded
    (no wpe table to run off the end of); with learned positions the usual
    max_seq_len cap applies and only the memory saving remains."""
    B, T0 = prompt.shape
    W = cfg.window
    assert W > 0, "generate_streaming requires a sliding-window config"
    if cfg.pos_emb != "rope":
        assert T0 + max_new <= cfg.max_seq_len
    chunk = min(T0, max(W, 1))
    caches = init_ring_kv(cfg, B, chunk)
    key, first_key = jax.random.split(key)
    # chunked prefill (static chunk count; S <= chunk by construction)
    logits = None
    for off in range(0, T0, chunk):
        S = min(chunk, T0 - off)
        logits, caches = forward_with_ring(params, prompt[:, off:off + S],
                                           caches, off, cfg)
    first = _sample(logits[:, -1, :], first_key, temperature, top_k, top_p)
    if max_new == 1:
        return jnp.concatenate([prompt, first[:, None]], axis=1)

    def decode(carry, step_key):
        tok, pos, caches = carry
        lg, caches = forward_with_ring(params, tok[:, None], caches, pos, cfg)
        nxt = _sample(lg[:, -1, :], step_key, temperature, top_k, top_p)
        return (nxt, pos + 1, caches), tok

    keys = jax.random.split(key, max_new - 1)
    (last, _, _), toks = jax.lax.scan(decode, (first, T0, caches), keys)
    gen = jnp.concatenate([toks.T, last[:, None]], axis=1)
    return jnp.concatenate([prompt, gen], axis=1)


# --------------------------------------------------------------------------
# Continuous-batching decode: per-slot positions (serving_gen.py engine)
# --------------------------------------------------------------------------

def _block_decode_multi(x, p, cfg, k_cache, v_cache, pos):
    """One block step for ONE new token per slot with per-slot positions.

    x: (B, 1, C); pos: (B,) int32 — each slot's write position.  The causal
    mask is per-slot (t <= pos[b]), so slots at different depths coexist in
    one batch — the kernel of continuous batching.  Caches are raw
    (B, Tmax, C) (int8 cache is a whole-batch layout; per-slot decode keeps
    the simpler form and quantized *weights* instead, see _plin)."""
    B, _, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    D = C // NH
    Tmax = k_cache.shape[1]
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = _plin(p, "qkvw", "qkvb", ln1)
    q, k, v = _split_qkv(qkv, cfg)                          # (B, 1, ·)
    if cfg.pos_emb == "rope":
        q, k = rope_qk(q, k, pos[:, None], cfg.num_heads, cfg.kv_heads)
    bidx = jnp.arange(B)
    k_cache = k_cache.at[bidx, pos].set(k[:, 0])
    v_cache = v_cache.at[bidx, pos].set(v[:, 0])
    kh = k_cache.reshape(B, Tmax, KH, D).transpose(0, 2, 1, 3)
    vh = v_cache.reshape(B, Tmax, KH, D).transpose(0, 2, 1, 3)
    qh = q.reshape(B, 1, NH, D).transpose(0, 2, 1, 3)       # (B, NH, 1, D)
    mask = jnp.arange(Tmax)[None, :] <= pos[:, None]        # (B, Tmax)
    if cfg.window:
        mask = jnp.logical_and(
            mask, jnp.arange(Tmax)[None, :] > pos[:, None] - cfg.window)
    atty = _cache_attention(qh, kh, vh, mask[:, None, :], x.dtype)
    atty = atty.transpose(0, 2, 1, 3).reshape(B, 1, C)
    x = x + _plin(p, "attprojw", "attprojb", atty)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    x = x + _mlp(p, cfg, ln2)
    return x, k_cache, v_cache


def decode_step_multi(params: Dict, tokens: jax.Array, caches, pos,
                      cfg: ViTConfig):
    """tokens (B,) at per-slot positions pos (B,) -> (logits (B, V), caches).

    Inactive slots simply carry a stale pos; their logits are computed and
    discarded by the engine (dense batch = one compiled program regardless
    of which slots are live — the XLA-friendly form of continuous batching).
    """
    k_caches, v_caches = caches
    dtype = jnp.dtype(cfg.dtype)
    int8_w = "wte_scale" in params
    emb = params["wte"][tokens].astype(dtype)
    if int8_w:
        emb = emb * params["wte_scale"][tokens][..., None].astype(dtype)
    x = (emb if cfg.pos_emb == "rope"
         else emb + params["wpe"][pos].astype(dtype))[:, None, :]
    blocks = {k: params[k] for k in _block_keys(params, cfg)}

    def step(x, layer):
        p, kc, vc = layer
        x, kc, vc = _block_decode_multi(x, p, cfg, kc, vc, pos)
        return x, (kc, vc)

    x, (k_caches, v_caches) = jax.lax.scan(step, x,
                                           (blocks, k_caches, v_caches))
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    if int8_w:
        from ..ops import quant
        logits = quant.linear_w8(lnf, params["wte"], params["wte_scale"])
    else:
        logits = basic.linear(lnf, params["wte"].astype(dtype), None)
    return logits[:, 0, :].astype(jnp.float32), (k_caches, v_caches)


def prefill_into_slot(params: Dict, prompt: jax.Array, caches, slot: int,
                      cfg: ViTConfig):
    """Run a (T0,) prompt through the stack, writing K/V into `slot`'s rows.
    Returns (last-token logits (V,), caches)."""
    k_caches, v_caches = caches
    kc1 = jax.lax.dynamic_slice_in_dim(k_caches, slot, 1, axis=1)
    vc1 = jax.lax.dynamic_slice_in_dim(v_caches, slot, 1, axis=1)
    logits, (kc1, vc1) = forward_with_cache(params, prompt[None], (kc1, vc1),
                                            0, cfg, last_only=True)
    k_caches = jax.lax.dynamic_update_slice_in_dim(k_caches, kc1, slot, axis=1)
    v_caches = jax.lax.dynamic_update_slice_in_dim(v_caches, vc1, slot, axis=1)
    return logits[0, -1, :], (k_caches, v_caches)


def prefill_into_slots(params: Dict, prompts: jax.Array, caches, slots,
                       cfg: ViTConfig):
    """Coalesced prefill: K same-bucket prompts through the stack in ONE
    dispatch, scattering K/V into K slot rows (serving_gen batches admission
    by bucket, so K prompts cost one dispatch instead of K).  prompts
    (K, T0), slots (K,) int32.  Duplicate slot entries
    (group padding) are benign: duplicates carry identical rows.
    Returns (last-row logits (K, V), caches)."""
    k_caches, v_caches = caches
    T0 = prompts.shape[1]
    kcK = jnp.take(k_caches, slots, axis=1)[:, :, :T0]
    vcK = jnp.take(v_caches, slots, axis=1)[:, :, :T0]
    logits, (kcK, vcK) = forward_with_cache(params, prompts, (kcK, vcK),
                                            0, cfg, last_only=True)
    k_caches = k_caches.at[:, slots, :T0].set(kcK)
    v_caches = v_caches.at[:, slots, :T0].set(vcK)
    return logits[:, -1, :], (k_caches, v_caches)


# --------------------------------------------------------------------------
# Paged KV cache (vLLM-style, XLA-static): block-pool + per-slot page table
# --------------------------------------------------------------------------
#
# The dense slot cache reserves max_slots * max_len rows; a paged pool holds
# N_PAGES fixed-size pages shared by all slots, with a host-managed page
# table mapping (slot, page-index) -> pool page.  Memory scales with TOTAL
# live tokens, not worst-case per slot — the property that lets a server
# admit many short requests alongside a few long ones.  All shapes are
# static: decode gathers each slot's pages (B, MAX_PP, PAGE, C) and masks by
# position, so XLA compiles one program for every occupancy pattern.

PAGE = 16                   # tokens per page


def init_paged_kv(cfg: ViTConfig, n_pages: int):
    dtype = jnp.dtype(cfg.dtype)
    shape = (cfg.num_layers, n_pages, PAGE, cfg.kv_dim)
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


def _block_decode_paged(x, p, cfg, kp, vp, table, pos):
    """kp/vp (N_PAGES, PAGE, kv_dim); table (B, MAX_PP) page ids; pos (B,)."""
    B, _, C = x.shape
    NH, KH = cfg.num_heads, cfg.kv_heads
    D = C // NH
    max_pp = table.shape[1]
    Tv = max_pp * PAGE                                  # virtual max length
    ln1 = basic.layernorm_cv(x, p["ln1w"], p["ln1b"])
    qkv = _plin(p, "qkvw", "qkvb", ln1)
    q, k, v = _split_qkv(qkv, cfg)                      # (B, 1, ·)
    if cfg.pos_emb == "rope":
        q, k = rope_qk(q, k, pos[:, None], cfg.num_heads, cfg.kv_heads)
    page_id = jnp.take_along_axis(table, (pos // PAGE)[:, None],
                                  axis=1)[:, 0]         # (B,)
    off = pos % PAGE
    kp = kp.at[page_id, off].set(k[:, 0])
    vp = vp.at[page_id, off].set(v[:, 0])
    kh = kp[table].reshape(B, Tv, KH, D).transpose(0, 2, 1, 3)
    vh = vp[table].reshape(B, Tv, KH, D).transpose(0, 2, 1, 3)
    qh = q.reshape(B, 1, NH, D).transpose(0, 2, 1, 3)
    mask = jnp.arange(Tv)[None, :] <= pos[:, None]
    if cfg.window:
        mask = jnp.logical_and(
            mask, jnp.arange(Tv)[None, :] > pos[:, None] - cfg.window)
    atty = _cache_attention(qh, kh, vh, mask[:, None, :], x.dtype)
    atty = atty.transpose(0, 2, 1, 3).reshape(B, 1, C)
    x = x + _plin(p, "attprojw", "attprojb", atty)
    ln2 = basic.layernorm_cv(x, p["ln2w"], p["ln2b"])
    x = x + _mlp(p, cfg, ln2)
    return x, kp, vp


def decode_step_paged(params: Dict, tokens: jax.Array, caches, table,
                      pos, cfg: ViTConfig):
    """Paged twin of decode_step_multi; table (B, MAX_PP), pos (B,)."""
    kps, vps = caches
    dtype = jnp.dtype(cfg.dtype)
    int8_w = "wte_scale" in params
    emb = params["wte"][tokens].astype(dtype)
    if int8_w:
        emb = emb * params["wte_scale"][tokens][..., None].astype(dtype)
    x = (emb if cfg.pos_emb == "rope"
         else emb + params["wpe"][pos].astype(dtype))[:, None, :]
    blocks = {k: params[k] for k in _block_keys(params, cfg)}

    def step(x, layer):
        p, kp, vp = layer
        x, kp, vp = _block_decode_paged(x, p, cfg, kp, vp, table, pos)
        return x, (kp, vp)

    x, (kps, vps) = jax.lax.scan(step, x, (blocks, kps, vps))
    lnf = basic.layernorm_cv(x, params["lnfw"], params["lnfb"])
    if int8_w:
        from ..ops import quant
        logits = quant.linear_w8(lnf, params["wte"], params["wte_scale"])
    else:
        logits = basic.linear(lnf, params["wte"].astype(dtype), None)
    return logits[:, 0, :].astype(jnp.float32), (kps, vps)


def prefill_into_pages(params: Dict, prompt: jax.Array, caches, page_ids,
                       cfg: ViTConfig):
    """Run a (T0,) prompt (T0 % PAGE == 0 via bucket padding) through the
    stack and scatter its K/V rows into the slot's pages.  page_ids
    (T0 // PAGE,) pool pages, in sequence order."""
    kps, vps = caches
    n_pg = prompt.shape[0] // PAGE
    kc1, vc1 = init_kv_cache(cfg, 1, prompt.shape[0])
    logits, (kc1, vc1) = forward_with_cache(params, prompt[None], (kc1, vc1),
                                            0, cfg, last_only=True)
    L, _, T0, C = kc1.shape
    kpages = kc1.reshape(L, n_pg, PAGE, C)
    vpages = vc1.reshape(L, n_pg, PAGE, C)
    kps = kps.at[:, page_ids].set(kpages)
    vps = vps.at[:, page_ids].set(vpages)
    return logits[0, -1, :], (kps, vps)


def prefill_into_pages_multi(params: Dict, prompts: jax.Array, caches,
                             page_ids, cfg: ViTConfig):
    """Coalesced paged prefill: K same-bucket prompts in one dispatch.
    prompts (K, T0) with T0 % PAGE == 0, page_ids (K, T0 // PAGE).
    Duplicate page-id rows (group padding) write identical content.
    Returns (last-row logits (K, V), caches)."""
    kps, vps = caches
    K, T0 = prompts.shape
    n_pg = T0 // PAGE
    kc, vc = init_kv_cache(cfg, K, T0)
    logits, (kc, vc) = forward_with_cache(params, prompts, (kc, vc), 0, cfg)
    L, _, _, C = kc.shape
    kpages = kc.reshape(L, K * n_pg, PAGE, C)
    vpages = vc.reshape(L, K * n_pg, PAGE, C)
    flat = page_ids.reshape(-1)
    kps = kps.at[:, flat].set(kpages)
    vps = vps.at[:, flat].set(vpages)
    return logits[:, -1, :], (kps, vps)


def decode_ticks_multi(params: Dict, tokens: jax.Array, caches, pos,
                       keys: jax.Array, temps: jax.Array, cfg: ViTConfig,
                       top_k: int, top_p: float = 0.0):
    """N decode ticks for all slots in ONE device program (lax.scan), with
    on-device sampling — one host sync per chunk instead of per token
    (serving_gen.GenerationEngine chunked mode).

    temps (B,) per-slot temperature; 0 = greedy.  top_k static (engine-wide
    in chunked mode).  Returns (tokens (N, B), caches, final pos).
    """
    def tick(carry, key):
        tok, p, cs = carry
        logits, cs = decode_step_multi(params, tok, cs, p, cfg)
        greedy = jnp.argmax(logits, axis=-1)
        lg = _filter_logits(logits / jnp.maximum(temps, 1e-6)[:, None],
                            top_k, top_p)
        sampled = jax.random.categorical(key, lg, axis=-1)
        nxt = jnp.where(temps == 0.0, greedy, sampled).astype(jnp.int32)
        return (nxt, p + 1, cs), nxt

    (tok, pos, caches), toks = jax.lax.scan(tick, (tokens, pos, caches),
                                            keys)
    return toks, caches, pos


def decode_ticks_paged(params: Dict, tokens: jax.Array, caches, table, pos,
                       keys: jax.Array, temps: jax.Array, cfg: ViTConfig,
                       top_k: int, top_p: float = 0.0):
    """Paged twin of decode_ticks_multi; pages for all N ticks must be
    pre-allocated in `table` (the engine grows allocations before the
    dispatch — allocation cannot happen mid-scan)."""
    def tick(carry, key):
        tok, p, cs = carry
        logits, cs = decode_step_paged(params, tok, cs, table, p, cfg)
        greedy = jnp.argmax(logits, axis=-1)
        lg = _filter_logits(logits / jnp.maximum(temps, 1e-6)[:, None],
                            top_k, top_p)
        sampled = jax.random.categorical(key, lg, axis=-1)
        nxt = jnp.where(temps == 0.0, greedy, sampled).astype(jnp.int32)
        return (nxt, p + 1, cs), nxt

    (tok, pos, caches), toks = jax.lax.scan(tick, (tokens, pos, caches),
                                            keys)
    return toks, caches, pos
