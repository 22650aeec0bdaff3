"""Per-kernel timings at the benchmark cells' shapes, on one GPU.

For each hand-written kernel the earlier accelerator build carried, this
times the candidates that replace it, forward plus backward where there is one:

* attention — `jax.nn.dot_product_attention` with implementation="cudnn"
  and "xla", and the Pallas (Triton) flash attention shipped with JAX
  (jax.experimental.pallas.ops.gpu.attention.mha, a library kernel), at
  GPT-2 B=32 T=1024 causal, ViT-B/16 B=64 T=197 bidirectional and MoE-8e
  B=24 T=1024 causal, H=12 D=64, bf16;
* head + cross-entropy — the weight-tied GPT-2 head with the vocab padded
  to 50304 vs unpadded 50257, B·T = 32·1024 rows;
* AdamW — the flat update (ops/optimizer.adamw_step) and the tree update
  (adamw_tree) over GPT-2 124M, against the 28 B/param memory bound;
* ceilings — a large bf16 matmul and a large copy, for scale.

Run on the card:  python benchmarks/bringup_kernels.py
Prints one JSON object per measurement and writes them all to
chiprun_out/bringup_kernels.json.  Times are medians of 5 windows of
10 calls, each window ending in block_until_ready.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vitrs_tpu import backend  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
RESULTS = []


def emit(rec):
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def time_ms(fn, *args, windows=5, calls=10):
    """Compile once, then the median over `windows` of the mean call time."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    means = []
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        means.append((time.perf_counter() - t0) / calls * 1e3)
    return float(np.median(means)), compile_s


def attention_candidates():
    from jax.experimental.pallas.ops.gpu import attention as lib_attention

    def xla_or_cudnn(impl):
        def f(q, k, v, causal):
            return jax.nn.dot_product_attention(q, k, v, is_causal=causal,
                                                implementation=impl)
        return f

    def pallas(q, k, v, causal):
        return lib_attention.mha(q, k, v, None,
                                 sm_scale=1.0 / q.shape[-1] ** 0.5,
                                 causal=causal)

    return {"cudnn": xla_or_cudnn("cudnn"), "xla": xla_or_cudnn("xla"),
            "pallas_triton_lib": pallas}


def bench_attention():
    cells = {"gpt2_124m": (32, 1024, True), "vit_b16": (64, 197, False),
             "moe_8e": (24, 1024, True)}
    H, D = 12, 64
    for cell, (B, T, causal) in cells.items():
        rng = np.random.default_rng(0)
        q, k, v = (jnp.asarray(rng.standard_normal((B, T, H, D)),
                               jnp.bfloat16) for _ in range(3))
        ct = jnp.asarray(rng.standard_normal((B, T, H, D)), jnp.float32)
        ref = None
        for name, attn in attention_candidates().items():
            rec = {"kernel": "attention", "cell": cell, "impl": name,
                   "shape": [B, T, H, D], "causal": causal}
            if name == "pallas_triton_lib" and T % 128:
                rec["error"] = f"T={T} is not a multiple of its 128 block"
                emit(rec)
                continue
            try:
                fwd = jax.jit(lambda q, k, v, a=attn: a(q, k, v, causal))
                out = fwd(q, k, v)
                if ref is None:
                    ref = out.astype(jnp.float32)
                rec["max_abs_diff_vs_first"] = float(
                    jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
                rec["fwd_ms"], _ = time_ms(fwd, q, k, v)

                def loss(q, k, v, a=attn):
                    return jnp.sum(a(q, k, v, causal).astype(jnp.float32) * ct)
                fb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
                rec["fwd_bwd_ms"], rec["compile_s"] = time_ms(fb, q, k, v)
            except Exception as e:      # a candidate that does not compile
                rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            emit(rec)


def bench_head_ce():
    from vitrs_tpu.ops import basic
    R, C, V = 32 * 1024, 768, 50257
    rng = np.random.default_rng(0)
    lnf = jnp.asarray(rng.standard_normal((R, C)) * 0.1, jnp.bfloat16)
    wte = jnp.asarray(rng.standard_normal((V, C)) * 0.02, jnp.float32)
    tgt = jnp.asarray(rng.integers(0, V, (R,)), jnp.int32)

    def padded(lnf, wte, tgt):
        Vp = basic.pad_vocab(V)
        w = jnp.pad(wte.astype(lnf.dtype), ((0, Vp - V), (0, 0)))
        logits = basic.linear(lnf, w, None)
        return jnp.mean(basic.cross_entropy_padded(logits, tgt, V))

    def unpadded(lnf, wte, tgt):
        logits = basic.linear(lnf, wte.astype(lnf.dtype), None)
        return jnp.mean(basic.cross_entropy_from_logits(logits, tgt))

    for name, f in (("padded_50304", padded), ("unpadded_50257", unpadded)):
        fb = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))
        ms, comp = time_ms(fb, lnf, wte, tgt)
        loss = float(fb(lnf, wte, tgt)[0])
        emit({"kernel": "head_ce", "impl": name, "rows": R, "fwd_bwd_ms": ms,
              "compile_s": comp, "loss": loss})


def bench_adamw():
    from vitrs_tpu import params as PRM
    from vitrs_tpu.config import get_config
    from vitrs_tpu.ops import optimizer as opt
    cfg = get_config("gpt2-124m")
    n = PRM.num_parameters(cfg)
    bound_ms = 28.0 * n / HBM_BYTES_PER_S * 1e3
    key = jax.random.PRNGKey(0)
    p = jax.random.normal(key, (n,), jnp.float32)
    g = p * 1e-3
    m = jnp.zeros((n,), jnp.float32)
    v = jnp.zeros((n,), jnp.float32)
    step, lr = jnp.asarray(3, jnp.int32), jnp.asarray(1e-3, jnp.float32)
    flat = jax.jit(lambda p, g, m, v: opt.adamw_step(p, g, m, v, step, lr,
                                                     weight_decay=0.1))
    ms, _ = time_ms(flat, p, g, m, v)
    emit({"kernel": "adamw", "impl": "flat_adamw_step", "params": n,
          "ms": ms, "bound_ms_28B_per_param": bound_ms,
          "roofline_share": bound_ms / ms})
    del p, g, m, v
    tree = PRM.init_params(cfg, key)
    gt = jax.tree.map(lambda x: x * 1e-3, tree)
    mt = jax.tree.map(jnp.zeros_like, tree)
    vt = jax.tree.map(jnp.zeros_like, tree)
    tstep = jax.jit(lambda p, g, m, v: opt.adamw_tree(
        p, g, m, v, step, lr, weight_decay=0.1,
        decay_mask=opt.decay_mask_2d(p)))
    ms, _ = time_ms(tstep, tree, gt, mt, vt)
    emit({"kernel": "adamw", "impl": "adamw_tree", "params": n, "ms": ms,
          "bound_ms_28B_per_param": bound_ms, "roofline_share": bound_ms / ms})


def bench_ceilings():
    N = 8192
    a = jnp.ones((N, N), jnp.bfloat16)
    mm = jax.jit(lambda a: jnp.dot(a, a, preferred_element_type=jnp.float32))
    ms, _ = time_ms(mm, a)
    emit({"kernel": "ceiling", "impl": "bf16_matmul_8192", "ms": ms,
          "tflops": 2 * N ** 3 / ms / 1e9})
    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)        # 1 GiB
    cp = jax.jit(lambda x: x * 2.0)
    ms, _ = time_ms(cp, x)
    emit({"kernel": "ceiling", "impl": "copy_1GiB", "ms": ms,
          "gb_per_s": 2 * x.nbytes / ms / 1e6})


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    backend.enable_compile_cache()
    emit({"device_kind": dev.device_kind,
          "nvidia_smi": backend.card_description(), "jax": jax.__version__})
    only = sys.argv[1:] or ["attention", "head_ce", "adamw", "ceilings"]
    for part in only:
        globals()[f"bench_{part}"]()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bringup_kernels.json", "w") as f:
        json.dump(RESULTS, f, indent=1)


if __name__ == "__main__":
    main()
