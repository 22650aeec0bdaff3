"""Training loop — the L4 layer the reference never wrote (gap G1; intended
llm.c shape per SURVEY.md §3.4: build → loop{load; forward; zero; backward;
step} → save).

Production shape here: one jit-compiled SPMD train step (forward + backward +
reduce-scatter + sharded fused AdamW + all-gather) fed by the double-buffered
native data pipeline, with:
  * structured metrics (step, loss, lr, images/sec/chip, MFU) — SURVEY.md §5.5
  * periodic atomic checkpoints carrying params + m/v + step + PRNG seed +
    dataloader cursor, and resume-from-latest — SURVEY.md §5.3-5.4
  * optional jax.profiler trace capture — SURVEY.md §5.1
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ViTConfig, get_config
from .. import checkpoint as ckpt_io
from .. import params as PRM
from ..data import datasets as D
from ..data.prefetch import DevicePrefetcher
from ..models import model as M
from ..ops import optimizer as opt
from ..parallel import data_parallel as dp
from ..utils import flops as F


@dataclasses.dataclass
class TrainConfig:
    preset: str = "vit-tiny-4-cifar10"
    dataset: str = "cifar10"
    data_dir: Optional[str] = None
    steps: int = 1000
    run_steps: int = 0             # stop after this many steps this run
                                   # (0 = run to `steps`); schedule still
                                   # spans `steps` — the kill-and-resume knob
    batch_size: int = 128
    lr: float = 1e-3
    warmup: int = 100
    weight_decay: float = 0.05
    min_lr: float = 1e-5
    seed: int = 0
    dtype: str = "bfloat16"
    log_every: int = 20
    ckpt_every: int = 500
    eval_every: int = 0            # 0 = only at end
    workdir: str = "/tmp/vitrs_run"
    resume: bool = True
    init_ckpt: Optional[str] = None  # warm-start weights (e.g. MAE encoder);
                                     # step/cursor NOT loaded — fresh schedule
    profile_at: int = 0            # capture a profiler trace at this step
    n_devices: int = 0             # 0 = all
    remat: bool = False
    label_smoothing: float = 0.0
    ema_decay: float = 0.0         # 0 = off; e.g. 0.9999 for ViT recipes
    log_grad_norm: bool = False    # SURVEY §5.5 metric (one extra psum)
    clip_norm: float = 0.0         # 0 = off; 1.0 = the standard GPT recipe
    decay_2d_only: bool = False    # llm.c decay policy: matrices only
    accum_steps: int = 1           # micro-batches per step (grad accumulation)
    mesh: str = ""                 # mesh spec, e.g. "dp=2,tp=2,pp=2" /
                                   # "ep=4" / "cp=2" / "fsdp" — routes to the
                                   # verified parallel step factories
                                   # (train/mesh.py); "" = the native DP
                                   # ZeRO-1 path below.  Checkpoints stay in
                                   # the canonical layout, so a run resumes
                                   # under a DIFFERENT mesh spec.
    optimizer: str = "adamw"       # "adamw" (fused ZeRO-1 default) | "muon"
                                   # (hybrid Muon/AdamW, ops/muon.py; tc.lr
                                   # becomes the MATRIX lr — ~0.02 scale —
                                   # and muon_adamw_lr drives the rest) |
                                   # "adafactor" (sublinear state,
                                   # ops/adafactor.py; tc.lr is the relative
                                   # step size — ~1e-2 scale)
    muon_adamw_lr: float = 6e-4    # AdamW lr for non-matrix leaves (muon)
    ra_ops: int = 0                # RandAugment ops per image (imagenet path)
    ra_mag: float = 0.0            # RandAugment magnitude in [0, 1]
    mixup_alpha: float = 0.0       # device-side mixup (vit mode)
    async_ckpt: bool = True        # background device->host snapshot writes
    model_overrides: Optional[dict] = None


def _latest_ckpt(workdir: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(workdir, "ckpt_*.bin")))
    return paths[-1] if paths else None


def evaluate(cfg: ViTConfig, params, ds: D.Dataset, batch: int = 256) -> dict:
    """Top-1 accuracy + mean loss over an eval dataset (eval transform)."""
    fwd = jax.jit(lambda p, x: M.vit_forward(p, x, cfg, train=False))
    correct, total, loss_sum = 0, 0, 0.0
    from ..ops import basic
    for start in range(0, len(ds) - batch + 1, batch):
        idx = np.arange(start, start + batch)
        from ..data import augment as A
        x = A.augment_batch(ds.images, idx, crop_pad=0, flip=False,
                            mean=ds.mean, std=ds.std)
        y = ds.labels[idx]
        logits = np.asarray(fwd(params, jnp.asarray(x)))
        correct += int((logits.argmax(-1) == y).sum())
        losses = np.asarray(basic.cross_entropy_from_logits(
            jnp.asarray(logits), jnp.asarray(y)))
        loss_sum += float(losses.sum())
        total += batch
    return {"acc": correct / max(total, 1), "loss": loss_sum / max(total, 1),
            "n": total}


def evaluate_gpt(cfg: ViTConfig, params, data_dir: Optional[str] = None,
                 seed: int = 0, batch: int = 16, max_batches: int = 8
                 ) -> dict:
    """Held-out val loss + perplexity for a GPT checkpoint over the
    reserved TokenLoader holdout windows (the split training never wraps
    into)."""
    from ..data import tokens as TOK
    stream = TOK.get_tokens(data_dir, cfg.vocab_size, seed=seed)
    total_w = (len(stream) - 1) // cfg.max_seq_len
    # split size derives from the stream alone (tokens.default_holdout), so
    # it always matches what training reserved regardless of eval batch
    holdout = TOK.default_holdout(total_w)
    batch = min(batch, holdout)
    val = TOK.TokenLoader(stream, batch, cfg.max_seq_len,
                          holdout=holdout, val=True)
    f = jax.jit(M.loss_fn, static_argnums=3)
    losses, n = [], min(max_batches, max(1, holdout // batch))
    for _ in range(n):
        xb, yb = val.next_batch()
        losses.append(float(f(params, jnp.asarray(xb), jnp.asarray(yb), cfg)))
    mean = float(np.mean(losses))
    return {"val_loss": mean, "ppl": float(np.exp(min(mean, 20.0))),
            "windows": n * batch}


def evaluate_streaming(cfg: ViTConfig, params, loader, max_batches: int = 0
                       ) -> dict:
    """Top-1 + mean loss over a StreamingLoader(train=False) — the imagenet
    eval path (resize shorter side then center-crop, one pass, no shuffle)."""
    from ..ops import basic
    fwd = jax.jit(lambda p, x: M.vit_forward(p, x, cfg, train=False))
    steps = loader.steps_per_epoch
    if max_batches:
        steps = min(steps, max_batches)
    correct, total, loss_sum = 0, 0, 0.0
    for _ in range(steps):
        x, y = loader.next_batch()
        logits = np.asarray(fwd(params, jnp.asarray(x)))
        correct += int((logits.argmax(-1) == y).sum())
        losses = np.asarray(basic.cross_entropy_from_logits(
            jnp.asarray(logits), jnp.asarray(y)))
        loss_sum += float(losses.sum())
        total += len(y)
    return {"acc": correct / max(total, 1), "loss": loss_sum / max(total, 1),
            "n": total}


def train(tc: TrainConfig) -> dict:
    os.makedirs(tc.workdir, exist_ok=True)
    cfg = get_config(tc.preset, dtype=tc.dtype, remat=tc.remat,
                     label_smoothing=tc.label_smoothing,
                     **(tc.model_overrides or {}))

    plan = None
    if tc.mesh:
        from .mesh import TrainKnobs, make_plan, parse_mesh
        spec = parse_mesh(tc.mesh)
        knobs = TrainKnobs(accum_steps=tc.accum_steps,
                           clip_norm=tc.clip_norm,
                           log_grad_norm=tc.log_grad_norm)
        plan = make_plan(cfg, spec, optimizer=tc.optimizer, knobs=knobs,
                         weight_decay=tc.weight_decay)
        if plan is None and spec.dp > 1 and not tc.n_devices:
            tc = dataclasses.replace(tc, n_devices=spec.dp)
    if plan is not None:
        return _train_mesh(tc, cfg, plan)

    mesh = dp.make_mesh(tc.n_devices)
    n_chips = mesh.size
    device_kind = jax.devices()[0].device_kind
    n = PRM.num_parameters(cfg)

    # ---- init or resume ----------------------------------------------------
    start_step, cursor = 0, 0
    latest = _latest_ckpt(tc.workdir) if tc.resume else None
    if latest:
        np_params, cfg_loaded, extras = ckpt_io.load_checkpoint(latest, cfg)
        params = {k: jnp.asarray(v) for k, v in np_params.items()}
        start_step, cursor = extras["step"], extras["cursor"]
        m_full = extras["m"] if extras["m"] is not None else np.zeros(n, np.float32)
        v_full = extras["v"] if extras["v"] is not None else np.zeros(n, np.float32)
        print(f"[resume] {latest} at step {start_step}, cursor {cursor}")
    elif tc.init_ckpt:
        np_params, _, _ = ckpt_io.load_checkpoint(tc.init_ckpt, cfg)
        params = {k: jnp.asarray(v) for k, v in np_params.items()}
        m_full = np.zeros(n, np.float32)
        v_full = np.zeros(n, np.float32)
        print(f"[init] warm start from {tc.init_ckpt}")
    else:
        params = PRM.init_params(cfg, jax.random.PRNGKey(tc.seed))
        m_full = np.zeros(n, np.float32)
        v_full = np.zeros(n, np.float32)

    params = dp.replicate(params, mesh)
    n_pad = dp.opt_state_shard_size(cfg, mesh) * n_chips
    from jax.sharding import NamedSharding, PartitionSpec as P
    opt_shard = NamedSharding(mesh, P("data"))
    m = jax.device_put(np.pad(m_full, (0, n_pad - n)), opt_shard)
    v = jax.device_put(np.pad(v_full, (0, n_pad - n)), opt_shard)

    # in-memory datasets ship uint8 batches and normalize on device (4x less
    # H2D; see DataLoader.device_normalize) — fetch the dataset stats early
    norm_stats = None
    if cfg.mode == "vit" and tc.dataset and tc.dataset != "imagenet":
        _ds_for_stats = D.get_dataset(tc.dataset, tc.data_dir, train=True)
        norm_stats = (_ds_for_stats.mean, _ds_for_stats.std)

    use_muon = tc.optimizer == "muon"
    use_af = tc.optimizer == "adafactor"
    mu_state = af_state = None
    if use_af:
        assert tc.accum_steps == 1 and tc.mixup_alpha == 0.0 and \
            not tc.log_grad_norm, \
            "adafactor path keeps the lean step (accum/mixup/norm: adamw)"
        from ..ops import adafactor as AF
        step_fn = dp.make_dp_train_step_adafactor(
            cfg, mesh, weight_decay_2d_only=True)
        from .. import checkpoint_tree as CT
        af_path = (os.path.join(tc.workdir, f"adafactor_{start_step:08d}.tree")
                   if latest else None)
        if af_path and os.path.exists(af_path):
            host_af, af_meta = CT.load_tree(af_path)
            # the m dict is empty at beta1=0 and empty pytrees do not
            # survive the tree writer — default it back
            af_state = AF.AdafactorState(
                **{k: jax.tree.map(jnp.asarray, host_af.get(k, {}))
                   for k in ("vr", "vc", "vf", "m")})
            # layout guard: the factored/full split depends on MIN_FACTOR —
            # a state written under a different gate would not error on its
            # own (a stale scalar vf placeholder broadcasts in the full-v
            # branch, silently resetting that leaf's second-moment EMA), so
            # validate every leaf shape against the current init layout
            expect = jax.eval_shape(AF.init_state, params)
            bad = [f"{f}[{k}]: {tuple(got[k].shape)} != {tuple(v.shape)}"
                   for f in ("vr", "vc", "vf")
                   for got in (getattr(af_state, f),)
                   for k, v in getattr(expect, f).items()
                   if k not in got or tuple(got[k].shape) != tuple(v.shape)]
            if bad:
                raise ValueError(
                    f"adafactor state in {af_path} does not match the current "
                    f"factoring layout (MIN_FACTOR={AF.MIN_FACTOR}); "
                    f"mismatched leaves: {bad[:4]}{'...' if len(bad) > 4 else ''} "
                    f"— delete the .tree to re-init (resets the optimizer EMA) "
                    f"or resume with the build that wrote it")
            cursor = int(af_meta.get("cursor", cursor))
            print(f"[resume] adafactor state from {af_path}, cursor {cursor}")
        else:
            af_state = AF.init_state(params)
    elif use_muon:
        assert tc.accum_steps == 1 and tc.mixup_alpha == 0.0 and \
            not tc.log_grad_norm, \
            "muon path wires clip_norm only (accum/mixup/grad-norm: adamw)"
        from ..ops import muon as MU
        step_fn = dp.make_dp_train_step_muon(cfg, mesh,
                                             clip_norm=tc.clip_norm,
                                             weight_decay=tc.weight_decay)
        # muon state rides a side tree (the flat-m/v checkpoint section is
        # the AdamW layout), resumed like the EMA tree
        from .. import checkpoint_tree as CT
        mu_path = (os.path.join(tc.workdir, f"muon_{start_step:08d}.tree")
                   if latest else None)
        if mu_path and os.path.exists(mu_path):
            host_mu, mu_meta = CT.load_tree(mu_path)
            mu_state = MU.MuonState(
                momentum=jax.tree.map(jnp.asarray, host_mu["momentum"]),
                m=jax.tree.map(jnp.asarray, host_mu["m"]),
                v=jax.tree.map(jnp.asarray, host_mu["v"]))
            # the .bin has no opt-state section in muon mode, so the data
            # cursor rides the tree's meta instead
            cursor = int(mu_meta.get("cursor", cursor))
            print(f"[resume] muon state from {mu_path}, cursor {cursor}")
        else:
            mu_state = MU.init_state(params)
    else:
        step_fn = dp.make_dp_train_step(cfg, mesh,
                                        accum_steps=tc.accum_steps,
                                        return_grad_norm=tc.log_grad_norm,
                                        mixup_alpha=tc.mixup_alpha,
                                        normalize=norm_stats,
                                        clip_norm=tc.clip_norm,
                                        decay_2d_only=tc.decay_2d_only)
    ema = None
    ema_update = None
    if tc.ema_decay > 0.0:
        from ..ops import ema as EMA
        from .. import checkpoint_tree as CT
        # resume the moving average alongside params: an EMA restarted from
        # the resume-point params would diverge from an uninterrupted run,
        # breaking the deterministic-resume contract the rest of the
        # checkpoint (params/m/v/cursor/seed) upholds
        ema_path = (os.path.join(tc.workdir, f"ema_{start_step:08d}.tree")
                    if latest else None)
        if ema_path and os.path.exists(ema_path):
            host_ema, _ = CT.load_tree(ema_path)
            ema = jax.tree.map(jnp.asarray, host_ema)
            print(f"[resume] EMA from {ema_path}")
        else:
            ema = jax.jit(EMA.init_ema)(params)
        ema_update = jax.jit(functools.partial(EMA.update_ema,
                                               decay=tc.ema_decay))

    # ---- data ---------------------------------------------------------------
    batch_sharding = NamedSharding(mesh, P("data"))
    if cfg.mode == "gpt":
        from ..data import tokens as TOK
        stream = TOK.get_tokens(tc.data_dir, cfg.vocab_size, seed=tc.seed)
        # reserve a tail of windows as a genuine held-out val split
        total_w = (len(stream) - 1) // cfg.max_seq_len
        gpt_holdout = TOK.default_holdout(total_w)
        loader = TOK.TokenLoader(stream, tc.batch_size, cfg.max_seq_len,
                                 cursor=cursor, holdout=gpt_holdout)
    elif tc.dataset == "imagenet":
        # streaming sharded-JPEG path (native decode + fused-affine augment)
        from ..data import imagenet as IN
        ds = IN.ShardedImageNet(tc.data_dir, split="train")
        loader = IN.StreamingLoader(ds, tc.batch_size, cfg.img_size,
                                    train=True, seed=tc.seed, cursor=cursor,
                                    ra_ops=tc.ra_ops, ra_mag=tc.ra_mag)
    else:
        ds = (_ds_for_stats if norm_stats is not None
              else D.get_dataset(tc.dataset, tc.data_dir, train=True))
        loader = D.DataLoader(ds, tc.batch_size, seed=tc.seed, train=True,
                              cursor=cursor,
                              device_normalize=norm_stats is not None)
    prefetcher = DevicePrefetcher(loader, sharding=batch_sharding)

    log_path = os.path.join(tc.workdir, "metrics.jsonl")
    log_f = open(log_path, "a")
    t_last = time.perf_counter()
    wd_host = np.float32(tc.weight_decay)
    imgs_since = 0
    summary = {}

    ckpt_async = None
    if tc.async_ckpt:
        from ..checkpoint_async import AsyncCheckpointer
        ckpt_async = AsyncCheckpointer()

    def save(step):
        # cursor = examples actually *consumed* by completed steps — NOT
        # loader.cursor, which runs ahead by the prefetch depth
        consumed = cursor + (step - start_step) * tc.batch_size
        path = os.path.join(tc.workdir, f"ckpt_{step:08d}.bin")
        if use_muon or use_af:
            # flat m/v is the AdamW layout; these states ride a side tree
            from .. import checkpoint_tree as CT
            ckpt_io.save_checkpoint(
                path, jax.device_get(params), cfg, step=step, seed=tc.seed,
                cursor=consumed)
            name = "muon" if use_muon else "adafactor"
            st = mu_state if use_muon else af_state
            CT.save_tree(os.path.join(tc.workdir, f"{name}_{step:08d}.tree"),
                         jax.device_get(st._asdict()),
                         meta={"step": step, "cursor": consumed})
        elif ckpt_async is not None:
            # device-side snapshot, write overlaps the next train steps
            ckpt_async.save(path, params, cfg, m=m, v=v, step=step,
                            seed=tc.seed, cursor=consumed, n_valid=n)
        else:
            ckpt_io.save_checkpoint(
                path, jax.device_get(params), cfg, m=np.asarray(m)[:n],
                v=np.asarray(v)[:n], step=step, seed=tc.seed, cursor=consumed)
        if ema is not None:
            from .. import checkpoint_tree as CT
            CT.save_tree(os.path.join(tc.workdir, f"ema_{step:08d}.tree"),
                         jax.device_get(ema),
                         meta={"decay": tc.ema_decay, "step": step})

    stop_step = (min(tc.steps, start_step + tc.run_steps) if tc.run_steps
                 else tc.steps)
    try:
        for step in range(start_step + 1, stop_step + 1):
            if tc.profile_at and step == tc.profile_at:
                jax.profiler.start_trace(os.path.join(tc.workdir, "profile"))
            images, labels = next(prefetcher)
            # host-side schedule + host scalars: the jitted step is the ONLY
            # device dispatch per iteration
            lr = opt.cosine_lr_host(step, tc.lr, tc.warmup, tc.steps,
                                    tc.min_lr)
            if use_af:
                params, af_state, loss = step_fn(
                    params, af_state, images, labels, np.int32(step),
                    np.float32(lr), wd_host)
                gnorm = None
            elif use_muon:
                # same cosine SHAPE for both halves of the hybrid: min_lr
                # scales proportionally so it is honored on the AdamW side
                aux_lr = opt.cosine_lr_host(
                    step, tc.muon_adamw_lr, tc.warmup, tc.steps,
                    tc.min_lr * tc.muon_adamw_lr / max(tc.lr, 1e-12))
                params, mu_state, loss = step_fn(
                    params, mu_state, images, labels, np.int32(step),
                    np.float32(lr), np.float32(aux_lr))
                gnorm = None
            else:
                outs = step_fn(
                    params, m, v, images, labels, np.int32(step),
                    np.float32(lr), wd_host)
                if tc.log_grad_norm:
                    params, m, v, loss, gnorm = outs
                else:
                    params, m, v, loss = outs
                    gnorm = None
            if ema_update is not None:
                ema = ema_update(ema, params)
            imgs_since += tc.batch_size
            if tc.profile_at and step == tc.profile_at:
                jax.block_until_ready(loss)
                jax.profiler.stop_trace()
            if step % tc.log_every == 0 or step == tc.steps:
                loss_val = float(loss)      # sync point
                now = time.perf_counter()
                ips = imgs_since / (now - t_last)
                mfu = F.mfu(ips, cfg, device_kind, n_chips)
                rec = {"step": step, "loss": round(loss_val, 5),
                       "lr": round(float(lr), 7),
                       "imgs_per_sec": round(ips, 1),
                       "imgs_per_sec_chip": round(ips / n_chips, 1),
                       "mfu": None if mfu is None else round(mfu, 4)}
                if gnorm is not None:
                    rec["grad_norm"] = round(float(gnorm), 5)
                print("[train] " + json.dumps(rec))
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if not np.isfinite(loss_val):
                    raise FloatingPointError(f"loss diverged at step {step}")
                t_last, imgs_since = time.perf_counter(), 0
            if tc.ckpt_every and step % tc.ckpt_every == 0:
                save(step)
        if stop_step > start_step:
            save(stop_step)
            summary["final_loss"] = float(loss)
        if ema is not None and stop_step > start_step:
            from .. import checkpoint_tree as CT
            from ..ops import ema as EMA
            CT.save_tree(os.path.join(tc.workdir, f"ema_{stop_step:08d}.tree"),
                         jax.device_get(ema), meta={"decay": tc.ema_decay,
                                                    "step": stop_step})
        if tc.dataset and stop_step == tc.steps:
            if ema is not None:
                from ..ops import ema as EMA
                params = EMA.ema_params(ema, params)   # eval with EMA weights
            host_params = jax.device_get(params)
            if cfg.mode == "gpt":
                # val loss over the RESERVED holdout windows — the training
                # wrap never touches these (tokens.TokenLoader holdout split)
                from ..data import tokens as TOK
                val = TOK.TokenLoader(loader.tokens, min(tc.batch_size, 16),
                                      cfg.max_seq_len,
                                      holdout=loader.holdout, val=True)
                xb, yb = val.next_batch()
                vloss = float(jax.jit(M.loss_fn, static_argnums=3)(
                    host_params, jnp.asarray(xb), jnp.asarray(yb), cfg))
                summary["eval"] = {"val_loss": vloss}
            elif tc.dataset == "imagenet":
                from ..data import imagenet as IN
                try:
                    val_ds = IN.ShardedImageNet(tc.data_dir, split="val")
                except FileNotFoundError:
                    val_ds = IN.ShardedImageNet(tc.data_dir, split="train")
                val_loader = IN.StreamingLoader(
                    val_ds, min(tc.batch_size, 256), cfg.img_size, train=False)
                summary["eval"] = evaluate_streaming(cfg, host_params,
                                                     val_loader)
            else:
                eval_ds = D.get_dataset(tc.dataset, tc.data_dir, train=False)
                summary["eval"] = evaluate(cfg, host_params, eval_ds,
                                           batch=min(256, len(eval_ds)))
            print("[eval] " + json.dumps(summary["eval"]))
    finally:
        prefetcher.close()
        if ckpt_async is not None:
            ckpt_async.close()     # drain pending writes before returning
        log_f.close()
    return summary


def _train_mesh(tc: TrainConfig, cfg: ViTConfig, plan) -> dict:
    """The mesh-spec trainer path: one Plan (train/mesh.py) wraps a verified
    parallel step factory behind the uniform place/init_opt/step/canonical
    interface.  Checkpoints are written in the CANONICAL layout (.bin params
    + meshopt_*.tree optimizer state keyed by canonical names), so a run
    checkpointed under one mesh resumes under any other — including the
    plain-DP path and single device."""
    import jax.numpy as jnp
    from .. import checkpoint_tree as CT
    assert tc.mixup_alpha == 0.0, \
        "mixup rides the native DP path (mesh-path steps wire accum_steps/" \
        "clip_norm/log_grad_norm — parallel/gradops.py; EMA is layout-" \
        "agnostic and rides every family)"
    plan.validate_batch(tc.batch_size, cfg)
    n_chips = plan.mesh.size
    device_kind = jax.devices()[0].device_kind

    # ---- init or resume (canonical layout) ---------------------------------
    start_step, cursor = 0, 0
    latest = _latest_ckpt(tc.workdir) if tc.resume else None
    opt_state = None
    if latest:
        np_params, _, extras = ckpt_io.load_checkpoint(latest, cfg)
        start_step, cursor = extras["step"], extras["cursor"]
        host_params = np_params
        opt_path = os.path.join(tc.workdir, f"meshopt_{start_step:08d}.tree")
        if os.path.exists(opt_path):
            host_opt, opt_meta = CT.load_tree(opt_path)
            saved_opt = opt_meta.get("optimizer")
            if saved_opt is not None and saved_opt != plan.optimizer:
                print(f"[resume] meshopt tree was written by --optimizer "
                      f"{saved_opt}; running {plan.optimizer} — "
                      f"re-initializing optimizer state")
            else:
                try:
                    opt_state = plan.opt_load(host_opt)
                except (KeyError, TypeError, AttributeError, ValueError) as e:
                    # Adafactor meshopt trees are keyed by the WRITING
                    # family's pytree names; a cross-family resume re-inits
                    # (the params stay canonical, so training continues).
                    print(f"[resume] optimizer state from mesh "
                          f"{opt_meta.get('mesh', '?')} is incompatible "
                          f"with mesh {plan.spec.describe()} "
                          f"({type(e).__name__}: {e}); re-initializing")
                    opt_state = None
            cursor = int(opt_meta.get("cursor", cursor))
        print(f"[resume] {latest} at step {start_step}, cursor {cursor} "
              f"(mesh {plan.spec.describe()})")
    elif tc.init_ckpt:
        np_params, _, _ = ckpt_io.load_checkpoint(tc.init_ckpt, cfg)
        host_params = np_params
        print(f"[init] warm start from {tc.init_ckpt}")
    else:
        host_params = jax.device_get(
            PRM.init_params(cfg, jax.random.PRNGKey(tc.seed)))

    params = plan.place(host_params)
    if opt_state is None:
        opt_state = plan.init_opt(params)

    # EMA (Polyak) rides every family: the update is elementwise, so the
    # EMA tree simply lives in the SAME sharded layout as the params; the
    # side tree is saved canonically (plan.to_canonical works on any
    # same-structure tree) and re-placed on resume
    ema = None
    ema_update = None
    if tc.ema_decay > 0.0:
        from ..ops import ema as EMA
        ema_path = (os.path.join(tc.workdir, f"ema_{start_step:08d}.tree")
                    if latest else None)
        if ema_path and os.path.exists(ema_path):
            host_ema, _ = CT.load_tree(ema_path)
            ema = plan.place(host_ema)
            print(f"[resume] EMA from {ema_path}")
        else:
            ema = jax.jit(EMA.init_ema)(params)
        ema_update = jax.jit(functools.partial(EMA.update_ema,
                                               decay=tc.ema_decay))

    # ---- data ---------------------------------------------------------------
    if cfg.mode == "gpt":
        from ..data import tokens as TOK
        stream = TOK.get_tokens(tc.data_dir, cfg.vocab_size, seed=tc.seed)
        total_w = (len(stream) - 1) // cfg.max_seq_len
        holdout = TOK.default_holdout(total_w)
        loader = TOK.TokenLoader(stream, tc.batch_size, cfg.max_seq_len,
                                 cursor=cursor, holdout=holdout)
    else:
        ds = D.get_dataset(tc.dataset, tc.data_dir, train=True)
        loader = D.DataLoader(ds, tc.batch_size, seed=tc.seed, train=True,
                              cursor=cursor)
    prefetcher = DevicePrefetcher(loader, sharding=plan.batch_sharding)

    log_path = os.path.join(tc.workdir, "metrics.jsonl")
    log_f = open(log_path, "a")
    t_last = time.perf_counter()
    wd_host = np.float32(tc.weight_decay)
    imgs_since = 0
    summary = {}

    def save(step):
        consumed = cursor + (step - start_step) * tc.batch_size
        path = os.path.join(tc.workdir, f"ckpt_{step:08d}.bin")
        ckpt_io.save_checkpoint(path, plan.to_canonical(params), cfg,
                                step=step, seed=tc.seed, cursor=consumed)
        CT.save_tree(os.path.join(tc.workdir, f"meshopt_{step:08d}.tree"),
                     plan.opt_save(opt_state),
                     meta={"step": step, "cursor": consumed,
                           "mesh": plan.spec.describe(),
                           "optimizer": plan.optimizer})
        if ema is not None:
            CT.save_tree(os.path.join(tc.workdir, f"ema_{step:08d}.tree"),
                         plan.to_canonical(ema),
                         meta={"decay": tc.ema_decay, "step": step})

    stop_step = (min(tc.steps, start_step + tc.run_steps) if tc.run_steps
                 else tc.steps)
    try:
        for step in range(start_step + 1, stop_step + 1):
            images, labels = next(prefetcher)
            lr = opt.cosine_lr_host(step, tc.lr, tc.warmup, tc.steps,
                                    tc.min_lr)
            if plan.optimizer == "muon":
                # the uniform 7th slot carries the Muon aux (AdamW) lr —
                # same cosine SHAPE as the DP muon path (wd factory-bound)
                aux = opt.cosine_lr_host(
                    step, tc.muon_adamw_lr, tc.warmup, tc.steps,
                    tc.min_lr * tc.muon_adamw_lr / max(tc.lr, 1e-12))
                seventh = np.float32(aux)
            else:
                seventh = wd_host
            outs = plan.step(
                params, opt_state, images, labels, np.int32(step),
                np.float32(lr), seventh)
            if plan.returns_gnorm:
                params, opt_state, loss, gnorm = outs
            else:
                params, opt_state, loss = outs
                gnorm = None
            if ema_update is not None:
                ema = ema_update(ema, params)
            imgs_since += tc.batch_size
            if step % tc.log_every == 0 or step == tc.steps:
                loss_val = float(loss)      # sync point
                now = time.perf_counter()
                ips = imgs_since / (now - t_last)
                mfu = F.mfu(ips, cfg, device_kind, n_chips)
                rec = {"step": step, "loss": round(loss_val, 5),
                       "lr": round(float(lr), 7),
                       "imgs_per_sec": round(ips, 1),
                       "imgs_per_sec_chip": round(ips / n_chips, 1),
                       "mfu": None if mfu is None else round(mfu, 4),
                       "mesh": plan.spec.describe()}
                if gnorm is not None:
                    rec["grad_norm"] = round(float(gnorm), 5)
                print("[train] " + json.dumps(rec))
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if not np.isfinite(loss_val):
                    raise FloatingPointError(f"loss diverged at step {step}")
                t_last, imgs_since = time.perf_counter(), 0
            if tc.ckpt_every and step % tc.ckpt_every == 0:
                save(step)
        if stop_step > start_step:
            save(stop_step)
            summary["final_loss"] = float(loss)
        if tc.dataset and stop_step == tc.steps:
            if ema is not None:
                from ..ops import ema as EMA
                host_params = plan.to_canonical(params)
                host_params = jax.device_get(jax.tree.map(
                    lambda e, p: np.asarray(e, dtype=np.asarray(p).dtype),
                    plan.to_canonical(ema), host_params))
            else:
                host_params = plan.to_canonical(params)
            if cfg.mode == "gpt":
                from ..data import tokens as TOK
                val = TOK.TokenLoader(loader.tokens, min(tc.batch_size, 16),
                                      cfg.max_seq_len,
                                      holdout=loader.holdout, val=True)
                xb, yb = val.next_batch()
                vloss = float(jax.jit(M.loss_fn, static_argnums=3)(
                    host_params, jnp.asarray(xb), jnp.asarray(yb), cfg))
                summary["eval"] = {"val_loss": vloss}
            else:
                eval_ds = D.get_dataset(tc.dataset, tc.data_dir, train=False)
                summary["eval"] = evaluate(cfg, host_params, eval_ds,
                                           batch=min(256, len(eval_ds)))
            print("[eval] " + json.dumps(summary["eval"]))
    finally:
        prefetcher.close()
        log_f.close()
    return summary
