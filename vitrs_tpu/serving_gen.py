"""Continuous-batching generation engine (GPT serving).

The reference's serving story is a batch `forward` without targets
(rusty_vit.rs:269-350); this module supplies the production text-serving
loop: a FIXED pool of decode slots driven by one compiled
program per tick, with requests admitted into free slots as others retire
— so throughput stays at the dense-batch rate even when sequences start
and finish at different times (the property continuous batching exists
for).  Dynamic shapes never reach XLA: inactive slots decode garbage that
the host discards, which costs a slot's worth of FLOPs rather than a
recompile.

Components:
  * `generate.prefill_into_slot` — one compiled prefill per prompt length
    bucket (prompts are right-padded up to the bucket; positions beyond
    the true length are overwritten during decode, never read, because the
    causal mask is per-slot `t <= pos`).
  * `generate.decode_step_multi` — ONE token for ALL slots per tick with
    per-slot positions.
  * host-side slot allocator + per-request sampling state.

Weight-only int8 params (ops/quant.py) pass straight through — both
compiled programs dispatch on the `_scale` leaves.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import ViTConfig
from .models import generate as G


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray                 # (T0,) int
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: Optional[int]
    out: List[int] = field(default_factory=list)
    slot: int = -1


class GenerationEngine:
    """Slot-pool continuous batching over one shared KV cache.

    >>> eng = GenerationEngine(params, cfg, max_slots=8, max_len=256)
    >>> eng.submit(prompt_tokens, max_new=64)
    >>> finished = eng.run()            # list of (rid, np.ndarray tokens)
    """

    def __init__(self, params: Dict, cfg: ViTConfig, max_slots: int,
                 max_len: int, seed: int = 0,
                 prompt_buckets: tuple = (32, 64, 128),
                 paged: bool = False, n_pages: int = 0,
                 decode_chunk: int = 1, top_k: int = 0,
                 top_p: float = 0.0):
        assert max_len <= cfg.max_seq_len
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = (tuple(sorted(b for b in prompt_buckets
                                     if b <= max_len))
                        or (max_len,))   # tiny configs: one bucket
        self.paged = paged
        self.free: List[int] = list(range(max_slots))
        self.active: Dict[int, _Request] = {}      # slot -> request
        self.pending: List[_Request] = []
        self.finished: List[_Request] = []
        self._next_rid = 0
        self._key = jax.random.PRNGKey(seed)
        # host mirrors of per-slot state fed to the decode program
        self._tokens = np.zeros(max_slots, np.int32)
        self._pos = np.zeros(max_slots, np.int32)
        # chunked decode: N on-device ticks + on-device sampling per host
        # sync (one dispatch and one host round trip per chunk, not per
        # token).  Sampling in chunked mode: per-slot temperature, but
        # ONE engine-wide static top_k (`top_k` here); per-request top_k is
        # honored only by the tick-at-a-time path.
        self.decode_chunk = decode_chunk
        self.top_k = top_k
        self.top_p = top_p            # engine-wide nucleus cutoff (chunked)
        if decode_chunk > 1:
            scan = (G.decode_ticks_paged if paged else G.decode_ticks_multi)
            self._decode_scan = jax.jit(
                functools.partial(scan, cfg=cfg, top_k=top_k, top_p=top_p),
                donate_argnums=(2,))

        if paged:
            # block-pool cache: memory = n_pages * PAGE tokens TOTAL, shared
            # by all slots; the dense form would reserve max_slots * max_len
            assert max_len % G.PAGE == 0
            assert all(b % G.PAGE == 0 for b in self.buckets)
            self.max_pp = max_len // G.PAGE
            if n_pages <= 0:
                # dense-equivalent pool (+1 for the reserved sink page)
                n_pages = max_slots * self.max_pp + 1
            self.caches = G.init_paged_kv(cfg, n_pages)
            # page 0 is a reserved write-sink: every slot in the dense decode
            # batch writes its K/V somewhere each tick, and a retired slot's
            # stale table row must never alias a page reallocated to a live
            # slot — pointing retired rows at page 0 makes those writes
            # harmless (page 0 is only ever read under the causal mask)
            self.free_pages: List[int] = list(range(1, n_pages))
            # host page table + per-slot allocated-token high-water mark
            self._table = np.zeros((max_slots, self.max_pp), np.int32)
            self._alloc = np.zeros(max_slots, np.int32)
            self._decode = jax.jit(functools.partial(G.decode_step_paged,
                                                     cfg=cfg),
                                   donate_argnums=(2,))
            self._prefill = jax.jit(
                functools.partial(G.prefill_into_pages_multi, cfg=cfg),
                donate_argnums=(2,))
        else:
            self.caches = G.init_kv_cache(cfg, max_slots, max_len)
            # caches donated: the pool updates in place instead of copying
            # the whole (L, slots, Tmax, C) buffer every tick
            self._decode = jax.jit(functools.partial(G.decode_step_multi,
                                                     cfg=cfg),
                                   donate_argnums=(2,))
            self._prefill = jax.jit(
                functools.partial(G.prefill_into_slots, cfg=cfg),
                donate_argnums=(2,))

    # ------------------------------------------------------------- intake

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 0.0,
               eos_id: Optional[int] = None) -> int:
        if self.decode_chunk > 1 and (top_k != self.top_k
                                      or top_p != self.top_p):
            # chunked decode samples on-device with the ONE engine-wide
            # static top_k baked into the compiled scan; surface the
            # limitation at the API boundary instead of silently ignoring
            # the per-request value (advisor r2 finding)
            import warnings
            warnings.warn(
                f"per-request top_k={top_k}/top_p={top_p} is ignored in "
                f"chunked mode (decode_chunk={self.decode_chunk} uses the "
                f"engine-wide top_k={self.top_k}/top_p={self.top_p}); pass "
                "them to the engine constructor or use decode_chunk=1",
                stacklevel=2)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            # _admit seeds decode with prompt[-1]; an empty prompt would
            # IndexError there mid-flight, killing the whole serving loop
            raise ValueError("empty prompt (use a BOS/<|endoftext|> id)")
        assert len(prompt) + max_new <= self.max_len, "request exceeds max_len"
        assert len(prompt) <= max(self.buckets), "prompt exceeds buckets"
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(rid, prompt, max_new, temperature,
                                     top_k, top_p, eos_id))
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def _release_pages(self, slot: int):
        n = int(self._alloc[slot]) // G.PAGE
        self.free_pages.extend(int(p) for p in self._table[slot, :n])
        self._table[slot] = 0              # retired writes land in page 0
        self._pos[slot] = 0
        self._alloc[slot] = 0

    def _admit(self):
        """Admit pending requests, COALESCING same-bucket prompts into one
        prefill dispatch (group size padded to a power of two so the set of
        compiled prefill programs stays small): a group of K prompts costs
        one dispatch instead of K."""
        while self.pending and self.free:
            head_bucket = self._bucket(len(self.pending[0].prompt))
            if self.paged and len(self.free_pages) < head_bucket // G.PAGE:
                return                             # wait for pages to free
            # same-bucket group, bounded by free slots (and pages)
            limit = len(self.free)
            if self.paged:
                limit = min(limit, len(self.free_pages)
                            // (head_bucket // G.PAGE))
            group, rest = [], []
            for req in self.pending:
                if (len(group) < limit
                        and self._bucket(len(req.prompt)) == head_bucket):
                    group.append(req)
                else:
                    rest.append(req)
            self.pending = rest

            K = len(group)
            K_pad = 1 << (K - 1).bit_length()      # pow2: bounded retraces
            prompts = np.zeros((K_pad, head_bucket), np.int32)
            slots = np.zeros(K_pad, np.int32)
            pids = np.zeros((K_pad, head_bucket // G.PAGE), np.int32)
            for j, req in enumerate(group):
                T0 = len(req.prompt)
                slot = self.free.pop()
                req.slot = slot
                # pad tokens write cache rows >= T0, but decode's causal
                # mask (t <= pos) never reads them before overwrite
                prompts[j, :T0] = req.prompt
                slots[j] = slot
                if self.paged:
                    n_pg = head_bucket // G.PAGE
                    mine = [self.free_pages.pop() for _ in range(n_pg)]
                    self._table[slot, :n_pg] = mine
                    self._alloc[slot] = head_bucket
                    pids[j] = mine
                # the last REAL prompt token's logits live at index T0-1;
                # with right-padding the returned last-row logits are the
                # pad's — so seed decode with the final prompt token at
                # pos T0-1 and let the first decode tick produce the first
                # new token.
                self._tokens[slot] = req.prompt[-1]
                self._pos[slot] = T0 - 1
                self.active[slot] = req
            # group padding: duplicate the last row — duplicate slot/page
            # indices scatter identical content, so the tie is benign
            for j in range(K, K_pad):
                prompts[j] = prompts[K - 1]
                slots[j] = slots[K - 1]
                pids[j] = pids[K - 1]
            if self.paged:
                _, self.caches = self._prefill(
                    self.params, jnp.asarray(prompts), self.caches,
                    jnp.asarray(pids))
            else:
                _, self.caches = self._prefill(
                    self.params, jnp.asarray(prompts), self.caches,
                    jnp.asarray(slots))

    # ------------------------------------------------------------- decode

    def _sample_host(self, req: _Request, logits: np.ndarray) -> int:
        if req.temperature == 0.0:
            return int(np.argmax(logits))
        self._key, k = jax.random.split(self._key)
        lg = logits / req.temperature
        if req.top_k:
            kth = np.sort(lg)[-req.top_k]
            lg = np.where(lg < kth, -np.inf, lg)
        if req.top_p and req.top_p < 1.0:
            srt = np.sort(lg)[::-1]
            e = np.exp(srt - srt[0])
            cum = np.cumsum(e / e.sum())
            kth = srt[np.searchsorted(cum, req.top_p)]  # first idx with cum>=p
            lg = np.where(lg < kth, -np.inf, lg)
        return int(jax.random.categorical(k, jnp.asarray(lg)))

    def step(self) -> List[_Request]:
        """One decode tick for every active slot; returns newly finished."""
        self._admit()
        if not self.active:
            return []
        if self.paged:
            # grow any slot whose next write position crosses its allocation
            for slot in self.active:
                if self._pos[slot] >= self._alloc[slot]:
                    if not self.free_pages:
                        raise RuntimeError(
                            "page pool exhausted; size n_pages for the "
                            "expected live-token total")
                    idx = int(self._alloc[slot]) // G.PAGE
                    self._table[slot, idx] = self.free_pages.pop()
                    self._alloc[slot] += G.PAGE
            logits, self.caches = self._decode(
                self.params, jnp.asarray(self._tokens), self.caches,
                jnp.asarray(self._table), jnp.asarray(self._pos))
        else:
            logits, self.caches = self._decode(
                self.params, jnp.asarray(self._tokens), self.caches,
                jnp.asarray(self._pos))
        logits = np.asarray(logits)
        done: List[_Request] = []
        for slot, req in list(self.active.items()):
            nxt = self._sample_host(req, logits[slot])
            req.out.append(nxt)
            self._tokens[slot] = nxt
            self._pos[slot] += 1
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if len(req.out) >= req.max_new or hit_eos:
                done.append(req)
                del self.active[slot]
                self.free.append(slot)
                if self.paged:
                    self._release_pages(slot)
        self.finished.extend(done)
        return done

    def step_chunk(self) -> List[_Request]:
        """Chunked tick: N tokens for every active slot in one dispatch.

        Slots that hit EOS/max_new mid-chunk waste their remaining ticks
        (the device keeps decoding them; the host discards) — the classic
        sync-batching trade, bounded by decode_chunk.
        """
        self._admit()
        if not self.active:
            return []
        # never let any slot's writes run past max_len
        room = min(self.max_len - int(self._pos[s]) for s in self.active)
        n = max(1, min(self.decode_chunk, room))
        if self.paged:
            # pre-allocate every page the chunk could touch (no allocation
            # mid-scan); fall back to single ticks if the pool is short
            need = []
            for slot in self.active:
                want = int(self._pos[slot]) + n
                have = int(self._alloc[slot])
                need.append((slot, max(0, -(-want // G.PAGE)
                                       - have // G.PAGE)))
            if sum(k for _, k in need) > len(self.free_pages):
                return self.step()
            for slot, k in need:
                for _ in range(k):
                    idx = int(self._alloc[slot]) // G.PAGE
                    self._table[slot, idx] = self.free_pages.pop()
                    self._alloc[slot] += G.PAGE
        temps = np.zeros(self.max_slots, np.float32)
        for slot, req in self.active.items():
            temps[slot] = req.temperature
        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, n)
        if self.paged:
            toks, self.caches, _ = self._decode_scan(
                self.params, jnp.asarray(self._tokens), self.caches,
                jnp.asarray(self._table), jnp.asarray(self._pos), keys,
                jnp.asarray(temps))
        else:
            toks, self.caches, _ = self._decode_scan(
                self.params, jnp.asarray(self._tokens), self.caches,
                jnp.asarray(self._pos), keys, jnp.asarray(temps))
        toks = np.asarray(toks)                     # (n, B): ONE host sync
        done: List[_Request] = []
        live = dict(self.active)
        for t in range(n):
            for slot, req in list(live.items()):
                nxt = int(toks[t, slot])
                req.out.append(nxt)
                hit_eos = req.eos_id is not None and nxt == req.eos_id
                if len(req.out) >= req.max_new or hit_eos:
                    done.append(req)
                    del live[slot]
                    del self.active[slot]
                    self.free.append(slot)
                    if self.paged:
                        self._release_pages(slot)
        for slot in live:
            self._tokens[slot] = int(toks[n - 1, slot])
            self._pos[slot] += n
        self.finished.extend(done)
        return done

    def run(self) -> List[tuple]:
        """Drive until every submitted request finishes."""
        while self.pending or self.active:
            self.step_chunk() if self.decode_chunk > 1 else self.step()
        out = [(r.rid, np.concatenate([r.prompt, np.asarray(r.out,
                                                            np.int32)]))
               for r in sorted(self.finished, key=lambda r: r.rid)]
        self.finished.clear()
        return out


class TextEngine:
    """Text-in/text-out front over GenerationEngine: a ByteBPETokenizer
    (data/tokenizer.py) encodes prompts, eos defaults to its <|endoftext|>
    id, and completions decode back to strings (trimmed at eos).

    The reference has no text surface at all (inputs are raw &[u32] ids,
    rusty_vit.rs:73); this closes the serving stack end-to-end.

    >>> te = TextEngine(params, cfg, tokenizer, max_slots=8, max_len=256)
    >>> te.generate(["Once upon a time"], max_new=32)[0]
    """

    def __init__(self, params: Dict, cfg: ViTConfig, tokenizer,
                 **engine_kw):
        assert tokenizer.vocab_size <= cfg.vocab_size, (
            tokenizer.vocab_size, cfg.vocab_size)
        self.tokenizer = tokenizer
        self.engine = GenerationEngine(params, cfg, **engine_kw)
        self.eos_id = tokenizer.eot_id

    def generate(self, prompts: List[str], max_new: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, echo_prompt: bool = False) -> List[str]:
        """Continuously-batched generation for a list of string prompts;
        returns the completions in submission order."""
        reqs = []
        for text in prompts:
            ids = self.tokenizer.encode(text)
            if not ids:                       # "" -> generate from BOS
                assert self.eos_id is not None, "empty prompt needs an eot id"
                ids = [self.eos_id]
            rid = self.engine.submit(np.asarray(ids, np.int32), max_new,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, eos_id=self.eos_id)
            reqs.append((rid, text, len(ids)))
        finished = dict(self.engine.run())
        outs = []
        for rid, text, n_prompt in reqs:
            gen = [int(t) for t in finished[rid][n_prompt:]]
            if self.eos_id is not None and self.eos_id in gen:
                gen = gen[:gen.index(self.eos_id)]
            completion = self.tokenizer.decode(gen)
            outs.append(text + completion if echo_prompt else completion)
        return outs
