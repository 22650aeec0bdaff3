#!/usr/bin/env python
"""Inference CLI — batch classification / embedding with throughput report
(BASELINE.json configs[1]: 'ViT-S/16 ImageNet-1k inference, bf16').

Examples:
  python infer.py --preset vit-s-16 --batch-size 256 --steps 20
  python infer.py --ckpt /tmp/run/ckpt_00001000.bin --batch-size 128
"""

import argparse
import json
import time


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="vit-s-16")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint path (else random init)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quant", default="none", choices=["none", "w8", "w8a8"],
                   help="int8 post-training quantization: w8 = weight-only "
                        "(bandwidth-bound), w8a8 = int8 matmuls "
                        "(compute-bound)")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from vitrs_tpu import ViT, backend, get_config
    from vitrs_tpu.utils import flops as F

    backend.enable_compile_cache()
    if args.ckpt:
        model = ViT.build_from_checkpoint(args.ckpt, dtype=args.dtype)
    else:
        model = ViT.from_config(get_config(args.preset, dtype=args.dtype))
    cfg = model.config
    B = args.batch_size
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(
        (B, cfg.img_size, cfg.img_size, cfg.in_chans), dtype=np.float32))

    if args.quant != "none":
        from vitrs_tpu.models import quantized as Q
        from vitrs_tpu.ops import quant
        qp = quant.quantize_params(model.params, mode=cfg.mode)
        w8a8 = args.quant == "w8a8"
        fwd = jax.jit(lambda p, x: Q.vit_forward_q(p, x, cfg, w8a8=w8a8))
        model_params = qp
    else:
        fwd = model._jit_logits
        model_params = model.params

    jax.block_until_ready(fwd(model_params, x))      # compile
    t0 = time.perf_counter()
    for _ in range(args.steps):
        logits = fwd(model_params, x)
    jax.block_until_ready(logits)
    dt = (time.perf_counter() - t0) / args.steps

    ips = B / dt
    dev = jax.devices()[0]
    mfu = F.mfu(ips, cfg, dev.device_kind, train=False)
    print(json.dumps({
        "metric": f"{args.preset} inference images/sec/chip "
                  f"({cfg.dtype if args.quant == 'none' else args.quant})",
        "quant": args.quant,
        "value": round(ips, 1),
        "unit": "images/sec/chip",
        "batch": B,
        "latency_ms": round(dt * 1e3, 2),
        "mfu": None if mfu is None else round(mfu, 4),
        "device": dev.device_kind,
    }))


if __name__ == "__main__":
    main()
