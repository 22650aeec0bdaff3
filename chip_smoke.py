"""Proof that the system runs on one GPU, through the entry points a user
calls.

Phases, each printed on its own line as it passes or fails:

  0. the device is a GPU; the card's name and power limit (nvidia-smi)
  1. parity at the models' widths:
     - the attention op against the dense reference (basic.attention_dense)
       for GPT-2 causal, ViT-B T=197, GQA kv=4 with rope, and window 256:
       forward and gradients, in fp32 and in the production bf16 form;
     - GPT-2 124M loss and gradient norm on one batch (B=4, T=1024): the
       production bf16 path against the fp32 dense path
  2. training: `train.py --preset gpt2-124m --batch-size 32` for 20 steps
     (loss finite and falling), gpt2-moe-8e with `--optimizer adafactor`
     for a few steps, and ViT-B/16 through the flat `vit.py` API for a few
     steps with a checkpoint round trip
  3. generation: GenerationEngine on gpt2-124m answers four requests, one
     longer than the middle prompt bucket, and a chunked prefill agrees with
     the whole-prompt prefill

Weights and data are random, made from fixed seeds.  Every fp32 reference
runs under jax.default_matmul_precision("highest"), since the card would
otherwise run fp32 matmuls in TF32.

With --multi (four cards) only the mesh path runs: `train.py --preset
gpt2-124m --mesh dp=2,tp=2` for a few steps, then the same seed and global
batch on one card, one run after the other, and their losses are compared.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and is printed only when every phase passed.  Without a GPU, or without the
rest of the repository beside it, the script exits non-zero.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# bf16 keeps 8 bits of mantissa (relative rounding 2^-8 ~ 4e-3 per value):
# outputs of the bf16 path are held to 1e-2 relative L2 error against fp32,
# gradients — one more chain of bf16 products — to 2e-2.
BF16_OUT_TOL = 1e-2
BF16_GRAD_TOL = 2e-2
# fp32 against fp32 at "highest": the two differ only in summation order.
FP32_TOL = 1e-4


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def rel_err(got, want) -> float:
    """Relative L2 error over all leaves of two matching pytrees."""
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    num = sum(float(jnp.sum(jnp.square(a.astype(jnp.float32)
                                       - b.astype(jnp.float32))))
              for a, b in zip(g, w))
    den = sum(float(jnp.sum(jnp.square(b.astype(jnp.float32)))) for b in w)
    return (num / den) ** 0.5


def check(name, value, tol):
    if not value <= tol:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")
    return f"{name} {value:.2e} (tol {tol:.0e})"


@contextlib.contextmanager
def argv(args):
    saved = sys.argv
    sys.argv = ["train.py"] + list(args)
    try:
        yield
    finally:
        sys.argv = saved


def read_losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return recs


# ---------------------------------------------------------------- phase 1

def attention_parity():
    from vitrs_tpu import backend
    from vitrs_tpu.ops.attention import attention
    cases = {   # name: (T, heads, kv_heads, causal, rope, window)
        "gpt2_causal": (1024, 12, 12, True, False, 0),
        "vit_b16_T197": (197, 12, 12, False, False, 0),
        "gqa_kv4_rope": (1024, 12, 4, True, True, 0),
        "window_256": (1024, 12, 12, True, False, 256),
    }
    lines = []
    for name, (T, H, KH, causal, rope, window) in cases.items():
        D = 64
        rng = np.random.default_rng(T + KH)
        qkv = jnp.asarray(rng.standard_normal((2, T, (H + 2 * KH) * D)),
                          jnp.float32)
        ct = jnp.asarray(rng.standard_normal((2, T, H * D)), jnp.float32)

        def loss(x, fused):
            out = attention(x, H, causal=causal, use_flash=fused,
                            window=window, rope=rope, kv_heads=KH)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        def run(x, fused):
            (_, out), g = jax.jit(jax.value_and_grad(
                lambda x: loss(x, fused), has_aux=True))(x)
            return out, g

        with jax.default_matmul_precision("highest"):
            ref_out, ref_g = run(qkv, False)
            f32_out, f32_g = run(qkv, True)
        x16 = qkv.astype(jnp.bfloat16)
        with jax.default_matmul_precision("highest"):
            ref16_out, ref16_g = run(x16.astype(jnp.float32), False)
        b16_out, b16_g = run(x16, True)
        impl = backend.attention_implementation(
            jax.default_backend(), jnp.bfloat16, D, T)
        lines.append(
            f"  {name} (bf16 -> {impl}): "
            + "; ".join([
                check("fp32 out", rel_err(f32_out, ref_out), FP32_TOL),
                check("fp32 grad", rel_err(f32_g, ref_g), FP32_TOL),
                check("bf16 out", rel_err(b16_out, ref16_out), BF16_OUT_TOL),
                check("bf16 grad", rel_err(b16_g, ref16_g), BF16_GRAD_TOL)]))
    return "\n".join(lines)


def gpt2_parity():
    from vitrs_tpu import params as PRM
    from vitrs_tpu.config import get_config
    from vitrs_tpu.models import model as M
    prod = get_config("gpt2-124m", dtype="bfloat16")
    ref = get_config("gpt2-124m", dtype="float32", use_flash=False)
    params = PRM.init_params(prod, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, prod.vocab_size, (4, 1024)))
    y = jnp.asarray(rng.integers(0, prod.vocab_size, (4, 1024)))

    def loss_gnorm(cfg):
        loss, g = jax.jit(jax.value_and_grad(M.loss_fn), static_argnums=3)(
            params, x, y, cfg)
        return float(loss), g

    with jax.default_matmul_precision("highest"):
        l_ref, g_ref = loss_gnorm(ref)
    l_prod, g_prod = loss_gnorm(prod)
    n_ref = float(jnp.sqrt(sum(jnp.sum(jnp.square(v))
                               for v in jax.tree_util.tree_leaves(g_ref))))
    n_prod = float(jnp.sqrt(sum(jnp.sum(jnp.square(v.astype(jnp.float32)))
                                for v in jax.tree_util.tree_leaves(g_prod))))
    return (f"  loss bf16 {l_prod:.5f} vs fp32 {l_ref:.5f}: "
            + check("rel", abs(l_prod - l_ref) / abs(l_ref), BF16_OUT_TOL)
            + f"; grad norm bf16 {n_prod:.5f} vs fp32 {n_ref:.5f}: "
            + check("rel", abs(n_prod - n_ref) / n_ref, BF16_GRAD_TOL)
            + f"; whole-gradient rel L2 {rel_err(g_prod, g_ref):.2e}")


# ---------------------------------------------------------------- phase 2

def train_cli(args):
    from vitrs_tpu.cli import train as cli_train
    with argv(args):
        cli_train.main()


def train_gpt2(tmp):
    wd = os.path.join(tmp, "gpt2")
    t0 = time.perf_counter()
    train_cli(["--preset", "gpt2-124m", "--batch-size", "32", "--steps", "20",
               "--warmup", "5", "--lr", "6e-4", "--weight-decay", "0.1",
               "--log-every", "1", "--ckpt-every", "0", "--no-resume",
               "--dataset", "", "--workdir", wd])
    recs = read_losses(wd)
    losses = [r["loss"] for r in recs]
    assert len(losses) == 20 and np.all(np.isfinite(losses)), losses
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    assert last < first, (first, last)
    tok_s = np.median([r["imgs_per_sec"] for r in recs[5:]]) * 1024
    return (f"  20 steps in {time.perf_counter() - t0:.0f} s (compile "
            f"included); loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
            f"steady {tok_s:,.0f} tok/s, mfu {recs[-1]['mfu']}")


def train_moe(tmp):
    wd = os.path.join(tmp, "moe")
    train_cli(["--preset", "gpt2-moe-8e", "--optimizer", "adafactor",
               "--batch-size", "8", "--steps", "4", "--warmup", "1",
               "--lr", "1e-2", "--log-every", "1", "--ckpt-every", "0",
               "--no-resume", "--dataset", "", "--workdir", wd])
    losses = [r["loss"] for r in read_losses(wd)]
    assert len(losses) == 4 and np.all(np.isfinite(losses)), losses
    return f"  4 steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}"


def train_vit_flat_api(tmp):
    from vitrs_tpu import ViT
    model = ViT.from_config("vit-b-16", seed=0, dtype="bfloat16")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, (32,))
    losses = [model.train_step(x, y, lr=1e-4) for _ in range(5)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    path = os.path.join(tmp, "vit_b16.bin")
    model.save_checkpoint(path)
    again = ViT.build_from_checkpoint(path, dtype="bfloat16")
    assert again.step == model.step and again.config == model.config
    a = model.train_step(x, y, lr=1e-4)
    b = again.train_step(x, y, lr=1e-4)
    assert abs(a - b) <= 1e-6 * abs(a), (a, b)
    return (f"  5 steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"resumed from checkpoint: next loss {b:.6f} == {a:.6f}")


# ---------------------------------------------------------------- phase 3

def greedy_margin(params, cfg, seq, n_prompt):
    """Greedy decoding picks the argmax of the bf16 logits; under the fp32
    model at "highest" the chosen token's logit must lie within 1% of the
    logit range of the maximum (a near-tie may flip between the two)."""
    from vitrs_tpu.models import model as M
    ref = cfg.replace(dtype="float32", use_flash=False)
    with jax.default_matmul_precision("highest"):
        logits = jax.jit(M.gpt_forward, static_argnums=2)(
            params, jnp.asarray(seq)[None], ref)[0]
    worst = 0.0
    for t in range(n_prompt, len(seq)):
        row = np.asarray(logits[t - 1])
        gap = (row.max() - row[seq[t]]) / (row.max() - row.min())
        worst = max(worst, float(gap))
    return worst


def generation(tmp):
    from vitrs_tpu import params as PRM
    from vitrs_tpu.config import get_config
    from vitrs_tpu.models import generate as G
    from vitrs_tpu.serving_gen import GenerationEngine
    cfg = get_config("gpt2-124m", dtype="bfloat16")
    params = PRM.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 100, 20)]
    eng = GenerationEngine(params, cfg, max_slots=4, max_len=256,
                           prompt_buckets=(32, 64, 128))
    for p in prompts:
        eng.submit(p, max_new=16)
    done = dict(eng.run())
    assert sorted(done) == [0, 1, 2, 3], sorted(done)
    worst = 0.0
    for rid, p in enumerate(prompts):
        toks = np.asarray(done[rid]).reshape(-1)[-16:]
        assert len(toks) == 16 and toks.max() < cfg.vocab_size
        worst = max(worst, greedy_margin(
            params, cfg, np.concatenate([p, toks]), len(p)))
    line = ("  engine: 4 requests (prompts 5/40/100/20 tokens) x 16 new; "
            + check("worst greedy logit gap", worst, 1e-2))

    # the whole prompt attends through the fused op; chunks after the
    # first attend to the bf16 cache in the dense form: two bf16 programs,
    # each within 1e-2 of fp32, so within 2e-2 of each other
    prefill = jax.jit(G.forward_with_cache, static_argnums=(3, 4, 5))
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 384)))
    whole, _ = prefill(params, prompt, G.init_kv_cache(cfg, 2, 384), 0, cfg,
                       True)
    chunked, caches = None, G.init_kv_cache(cfg, 2, 384)
    for off in range(0, 384, 128):
        chunked, caches = prefill(params, prompt[:, off:off + 128], caches,
                                  off, cfg, True)
    line += "\n  chunked prefill (3 x 128) vs whole 384: " + check(
        "last logits rel", rel_err(chunked, whole), BF16_GRAD_TOL)
    return line


# ---------------------------------------------------------------- --multi

def multi_card(tmp):
    common = ["--preset", "gpt2-124m", "--batch-size", "16", "--steps", "5",
              "--warmup", "2", "--lr", "6e-4", "--log-every", "1",
              "--ckpt-every", "0", "--no-resume", "--dataset", ""]
    wd_mesh, wd_one = os.path.join(tmp, "mesh"), os.path.join(tmp, "one")
    train_cli(common + ["--mesh", "dp=2,tp=2", "--workdir", wd_mesh])
    train_cli(common + ["--n-devices", "1", "--workdir", wd_one])
    mesh = [r["loss"] for r in read_losses(wd_mesh)]
    one = [r["loss"] for r in read_losses(wd_one)]
    assert len(mesh) == len(one) == 5, (mesh, one)
    worst = max(abs(a - b) / abs(b) for a, b in zip(mesh, one))
    return (f"  dp=2,tp=2 losses {[round(v, 4) for v in mesh]}\n"
            f"  one card  losses {[round(v, 4) for v in one]}\n  "
            + check("worst per-step loss rel diff", worst, BF16_OUT_TOL))


def main():
    multi = "--multi" in sys.argv[1:]
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"phase 0 device: FAILED — JAX found {devices[0].platform}, "
              f"not a GPU", flush=True)
        return 1
    from vitrs_tpu import backend
    backend.enable_compile_cache()
    print(backend.card_description(), flush=True)
    print(f"phase 0 device: ok — {devices[0].device_kind} x {len(devices)}, "
          f"jax {jax.__version__}", flush=True)

    if multi:
        if len(devices) < 4:
            print(f"phase 4 multi-card: FAILED — needs 4 cards, found "
                  f"{len(devices)}", flush=True)
            return 1
        phases = [("4 multi-card dp=2,tp=2 vs one card", multi_card)]
    else:
        phases = [
            ("1 attention parity", lambda tmp: attention_parity()),
            ("1 gpt2-124m parity", lambda tmp: gpt2_parity()),
            ("2 train.py gpt2-124m", train_gpt2),
            ("2 train.py gpt2-moe-8e adafactor", train_moe),
            ("2 vit.py ViT-B/16", train_vit_flat_api),
            ("3 generation", generation),
        ]
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                detail = fn(tmp)
                print(f"phase {name}: ok ({time.perf_counter() - t0:.0f} s)"
                      f"\n{detail}", flush=True)
            except Exception:
                failed.append(name)
                print(f"phase {name}: FAILED", flush=True)
                traceback.print_exc()
                sys.stdout.flush()
    if failed:
        print(f"failed phases: {failed}", flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
