#!/usr/bin/env python
"""Train CLI — the entry point the reference never shipped (gap G1).

Examples:
  python train.py --preset vit-tiny-4-cifar10 --steps 2000 --batch-size 128
  python train.py --preset vit-b-16 --dataset synthetic-imagenet --steps 100
  python train.py --preset vit-tiny-4-cifar10 --resume --workdir /tmp/run1
"""

import argparse


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="vit-tiny-4-cifar10",
                   help="model preset (see vitrs_tpu.config.PRESETS)")
    p.add_argument("--dataset", default="cifar10",
                   help="cifar10 | synthetic-imagenet")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--workdir", default="/tmp/vitrs_run")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing over blocks")
    p.add_argument("--profile-at", type=int, default=0,
                   help="capture a jax.profiler trace at this step")
    p.add_argument("--n-devices", type=int, default=0, help="0 = all")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="e.g. 0.9999; 0 disables EMA")
    p.add_argument("--log-grad-norm", action="store_true")
    p.add_argument("--decay-2d-only", action="store_true",
                   help="weight-decay matrix tensors only (llm.c policy)")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global grad-norm clip (1.0 = standard GPT recipe)")
    p.add_argument("--drop-path", type=float, default=0.0,
                   help="stochastic depth rate (ViT-L recipes: 0.1-0.3)")
    p.add_argument("--kv-heads", type=int, default=0,
                   help="GQA/MQA K/V head count (0 = MHA)")
    p.add_argument("--pos-emb", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (gpt mode; 0 = full)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="MoE experts per layer (0 = dense MLP; ops/moe.py)")
    p.add_argument("--moe-top-k", type=int, default=2,
                   help="experts run per token under --num-experts")
    p.add_argument("--mesh", default="",
                   help="mesh spec routing to the verified parallel step "
                        "factories (train/mesh.py): e.g. 'dp=2,tp=2,pp=2', "
                        "'dp=2,tp=2,sp', 'tp=4,vp', 'dp=2,ep=4', "
                        "'ep=2,tp=2', 'cp=4', 'pp=4,schedule=1f1b', "
                        "'pp=2,schedule=1f1b-interleaved,v=2,mb=8', 'fsdp'. "
                        "Checkpoints stay canonical — a run resumes under a "
                        "different mesh (or none)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation micro-batches per step")
    p.add_argument("--ra-ops", type=int, default=0,
                   help="RandAugment ops per image (imagenet loader)")
    p.add_argument("--ra-mag", type=float, default=0.0,
                   help="RandAugment magnitude in [0, 1]")
    p.add_argument("--mixup-alpha", type=float, default=0.0,
                   help="device-side mixup Beta(a, a); 0 = off")
    p.add_argument("--init-ckpt", default=None,
                   help="warm-start weights (e.g. MAE-pretrained encoder)")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "muon", "adafactor"],
                   help="muon = hybrid Muon/AdamW (ops/muon.py); --lr then "
                        "sets the MATRIX lr (~0.02 scale).  adafactor = "
                        "sublinear optimizer state (ops/adafactor.py); "
                        "--lr is the relative step size (~1e-2 scale)")
    p.add_argument("--muon-adamw-lr", type=float, default=6e-4,
                   help="AdamW lr for non-matrix leaves under --optimizer "
                        "muon")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate the latest checkpoint in --workdir and exit")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from vitrs_tpu import backend
    backend.enable_compile_cache()

    if args.eval_only:
        import glob
        import json
        import jax
        from vitrs_tpu import checkpoint as C
        from vitrs_tpu.data import datasets as D
        from vitrs_tpu.train.loop import evaluate
        paths = sorted(glob.glob(f"{args.workdir}/ckpt_*.bin"))
        assert paths, f"no checkpoints in {args.workdir}"
        params, cfg, extras = C.load_checkpoint(paths[-1])
        if cfg.mode == "gpt":
            from vitrs_tpu.train.loop import evaluate_gpt
            res = evaluate_gpt(cfg, params, args.data_dir, seed=args.seed)
        else:
            eval_ds = D.get_dataset(args.dataset, args.data_dir, train=False)
            res = evaluate(cfg, params, eval_ds, batch=min(256, len(eval_ds)))
        print(json.dumps({"ckpt": paths[-1], "step": extras["step"], **res}))
        return

    from vitrs_tpu.train.loop import TrainConfig, train
    tc = TrainConfig(
        preset=args.preset, dataset=args.dataset, data_dir=args.data_dir,
        steps=args.steps, batch_size=args.batch_size, lr=args.lr,
        warmup=args.warmup, weight_decay=args.weight_decay, seed=args.seed,
        dtype=args.dtype, workdir=args.workdir, log_every=args.log_every,
        ckpt_every=args.ckpt_every, resume=not args.no_resume,
        remat=args.remat, profile_at=args.profile_at, mesh=args.mesh,
        n_devices=args.n_devices, label_smoothing=args.label_smoothing,
        ema_decay=args.ema_decay, init_ckpt=args.init_ckpt,
        log_grad_norm=args.log_grad_norm, clip_norm=args.clip_norm,
        decay_2d_only=args.decay_2d_only,
        accum_steps=args.accum_steps,
        ra_ops=args.ra_ops,
        ra_mag=args.ra_mag, mixup_alpha=args.mixup_alpha,
        optimizer=args.optimizer, muon_adamw_lr=args.muon_adamw_lr,
        model_overrides={
            k: v for k, v in (("drop_path", args.drop_path),
                              ("num_kv_heads", args.kv_heads),
                              ("pos_emb", args.pos_emb),
                              ("window", args.window),
                              ("num_experts", args.num_experts),
                              ("moe_top_k",
                               args.moe_top_k if args.num_experts else 0))
            if v not in (0, 0.0, "learned")} or None)
    summary = train(tc)
    print("[done]", summary)


if __name__ == "__main__":
    main()
