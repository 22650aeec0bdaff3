"""Speculative decoding — draft-model proposal + single target verify pass.

Latency lever for small-batch generation (the regime where decode is
bandwidth/dispatch-bound, BASELINE.md generation row): a cheap draft model
proposes K tokens autoregressively, the target model scores all K+1
positions in ONE forward, and the leading agreeing prefix is accepted —
so the expensive model runs once per ~(accepted+1) tokens instead of once
per token.  Output is EXACTLY the target model's (greedy: bitwise; sampled:
the Leviathan et al. 2023 rejection rule preserves the target distribution).

Cache management: there is NO rollback machinery.  Both KV
caches are position-masked (attention reads rows <= pos, the same contract
the serving engine's padded prefill relies on, models/generate.py), and the
iteration structure guarantees every stale row written by a rejected draft
is overwritten before any later read:

  draft step j consumes the token at position pos-1+j and writes that row;
  after accepting `a <= K` tokens the next iteration restarts at
  pos_new-1 = pos+a — exactly the first potentially-stale row.

The whole generator is one jitted `lax.while_loop` (static K, static
sampling knobs): no per-token host round-trips beyond the loop itself.

The reference has no generation surface at all (SURVEY.md: forward without
targets is its only inference, rusty_vit.rs:269-350); this composes the
framework's own KV-cache machinery (generate.forward_with_cache).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import ViTConfig
from .generate import forward_with_cache, init_kv_cache, _filter_logits


@functools.partial(jax.jit, static_argnames=(
    "target_cfg", "draft_cfg", "max_new", "K", "temperature", "top_k",
    "top_p"))
def generate_speculative(target_params: Dict, draft_params: Dict,
                         prompt: jax.Array, target_cfg: ViTConfig,
                         draft_cfg: ViTConfig, max_new: int, K: int,
                         key: jax.Array, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 0.0
                         ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """prompt (1, T0) -> ((1, T0 + max_new), stats).

    stats: target_calls (i32), drafted (i32), accepted (i32) — the
    acceptance rate `accepted / drafted` is the whole game: tokens per
    target call = 1 + K * rate.
    Greedy (temperature=0) output is bitwise identical to
    `generate(target_params, ...)`; sampled mode preserves the target
    distribution via the rejection rule."""
    B, T0 = prompt.shape
    assert B == 1, "speculative decoding is the small-batch latency path"
    assert K >= 1
    Tmax = T0 + max_new + K + 1          # slack: last round may overshoot
    V = target_cfg.vocab_size
    assert draft_cfg.vocab_size == V, "draft/target must share the vocab"

    t_caches = init_kv_cache(target_cfg, B, Tmax)
    d_caches = init_kv_cache(draft_cfg, B, Tmax)
    # prefill BOTH on the full prompt; row T0-1 is rewritten by the first
    # draft/verify chunk with identical content (position-masked caches)
    _, t_caches = forward_with_cache(target_params, prompt, t_caches, 0,
                                     target_cfg)
    _, d_caches = forward_with_cache(draft_params, prompt, d_caches, 0,
                                     draft_cfg)

    buf = jnp.zeros((1, Tmax), jnp.int32)
    buf = jax.lax.dynamic_update_slice(buf, prompt.astype(jnp.int32), (0, 0))

    def probs_of(logits):
        return jax.nn.softmax(
            _filter_logits(logits / max(temperature, 1e-6), top_k, top_p),
            axis=-1)

    def body(state):
        buf, n, d_caches, t_caches, drafted, accepted, calls = state
        pos = T0 + n
        it_key = jax.random.fold_in(key, n)
        last = jax.lax.dynamic_slice(buf, (0, pos - 1), (1, 1))

        # ---- draft K tokens (cheap model, K sequential steps) ----
        def dstep(carry, j):
            tok, dc = carry
            lg, dc = forward_with_cache(draft_params, tok, dc,
                                        pos - 1 + j, draft_cfg)
            lg = lg[:, -1]                              # (1, V)
            if temperature == 0.0:
                nxt = jnp.argmax(lg, axis=-1)
                q = jax.nn.one_hot(nxt, V)[0]
            else:
                q = probs_of(lg)[0]
                nxt = jax.random.categorical(
                    jax.random.fold_in(it_key, j),
                    jnp.log(jnp.maximum(q, 1e-30)))[None]
            return (nxt[:, None].astype(jnp.int32), dc), (nxt[0], q)

        (_, d_caches), (drafts, qs) = jax.lax.scan(
            dstep, (last, d_caches), jnp.arange(K))     # (K,), (K, V)

        # ---- one target pass over [last, d_1..d_K] ----
        chunk = jnp.concatenate([last[0], drafts]).astype(jnp.int32)[None]
        t_lg, t_caches = forward_with_cache(target_params, chunk, t_caches,
                                            pos - 1, target_cfg)
        t_lg = t_lg[0]                                   # (K+1, V)

        if temperature == 0.0:
            tgt = jnp.argmax(t_lg, axis=-1)              # (K+1,)
            ok = drafts == tgt[:K]
            a = jnp.sum(jnp.cumprod(ok.astype(jnp.int32)))
            emit = tgt                                    # greedy: ok_j =>
            #                                               drafts_j == tgt_j
        else:
            ps = probs_of(t_lg)                          # (K+1, V)
            p_d = ps[jnp.arange(K), drafts]
            q_d = qs[jnp.arange(K), drafts]
            u = jax.random.uniform(jax.random.fold_in(it_key, 7919), (K,))
            ok = u < p_d / jnp.maximum(q_d, 1e-30)
            a = jnp.sum(jnp.cumprod(ok.astype(jnp.int32)))
            # correction at position a: resample from max(p - q, 0) when a
            # draft was rejected, from p_K (the bonus token) when all passed
            resid = jnp.maximum(ps[:K] - qs, 0.0)        # (K, V)
            resid = resid / jnp.maximum(resid.sum(-1, keepdims=True), 1e-30)
            dists = jnp.concatenate([resid, ps[K:]], axis=0)   # (K+1, V)
            corr = jax.random.categorical(
                jax.random.fold_in(it_key, 104729),
                jnp.log(jnp.maximum(dists[a], 1e-30)))
            emit = jnp.where(jnp.arange(K + 1) < a,
                             jnp.concatenate([drafts, drafts[-1:]]), corr)

        buf = jax.lax.dynamic_update_slice(
            buf, emit.astype(jnp.int32)[None], (0, pos))
        return (buf, n + a + 1, d_caches, t_caches,
                drafted + K, accepted + a, calls + 1)

    def cond(state):
        return state[1] < max_new

    state = (buf, jnp.asarray(0, jnp.int32), d_caches, t_caches,
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(0, jnp.int32))
    buf, n, _, _, drafted, accepted, calls = jax.lax.while_loop(
        cond, body, state)
    stats = {"target_calls": calls, "drafted": drafted,
             "accepted": accepted}
    return jax.lax.slice(buf, (0, 0), (1, T0 + max_new)), stats
